"""data.list maker: wav.scp + text + durations -> JSONL.

Copy of wekws_tpu/tools/make_list.py (the reference wekws's
tools/make_list.py): joins the Kaldi-style tables into ``{key, txt,
duration, wav}`` lines.
"""

import json
from typing import Dict, Optional


def read_table(path: str) -> Dict[str, str]:
    table = {}
    with open(path, encoding="utf8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                table[parts[0]] = parts[1]
            elif len(parts) == 1:
                table[parts[0]] = ""
    return table


def make_list(
    wav_scp: str,
    text_file: str,
    duration_file: Optional[str],
    out_path: str,
) -> int:
    wavs = read_table(wav_scp)
    texts = read_table(text_file)
    durations = read_table(duration_file) if duration_file else {}
    n = 0
    with open(out_path, "w", encoding="utf8") as f:
        for key, wav in wavs.items():
            if key not in texts:
                continue
            entry = {"key": key, "txt": texts[key], "wav": wav}
            if key in durations:
                entry["duration"] = float(durations[key])
            f.write(json.dumps(entry, ensure_ascii=False) + "\n")
            n += 1
    return n
