"""Waveform duration computation.

Copy of wekws_tpu/tools/durations.py (the reference wekws's
tools/wav_to_duration.sh + wav2dur.py): reads each wav and writes
``key duration`` lines.
"""

from typing import Dict, Iterable, Optional, Tuple

from wekws_tpu_torch.data.audio import read_wav


def wav_durations(
    scp_entries: Iterable[Tuple[str, str]],
    out_path: Optional[str] = None,
) -> Dict[str, float]:
    out = {}
    for key, path in scp_entries:
        wave, sr = read_wav(path)
        out[key] = len(wave) / sr
    if out_path is not None:
        with open(out_path, "w", encoding="utf8") as f:
            for key, dur in out.items():
                f.write(f"{key} {dur:.4f}\n")
    return out
