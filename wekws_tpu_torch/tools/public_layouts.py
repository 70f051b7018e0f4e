"""Miniature corpora in the file layouts of the public keyword-spotting
datasets, written from a seed with numpy.

They stand in for the public corpora until those are in the repository:
a recipe's stage 0 reads a layout written here as it reads the real
download, so every stage of ``examples/{hey_snips,hi_xiaowen,
speechcommand_v1}/run*_torch.sh`` runs end to end on a small corpus, at
the models' published widths.  Three layouts:

* ``snips`` (the Snips "Hey Snips" research set): ``{train,dev,test}.json``,
  each a list of ``{id, audio_file_path, is_hotword, worker_id,
  duration}``, and the wavs under ``audio_files/``;
* ``mobvoi`` (Mobvoi hotword, openslr-87): the wavs in a flat
  ``mobvoi_hotword_dataset/<utt_id>.wav`` and
  ``mobvoi_hotword_dataset_resources/{p,n}_{train,dev,test}.json``, each a
  list of ``{utt_id, speaker_id, keyword_id}`` (0 Hi Xiaowen, 1 Nihao
  Wenwen, -1 filler).  ``--ctc_data DIR`` also writes each split's
  ``wav.scp`` and character transcripts (``text``: 嗨小问, 你好问问, or
  other characters for a filler) under ``DIR/{train,dev,test}``: the
  files that ``run_ctc*.sh``'s stage 1 reads (on the real corpus a
  transcription resource gives them).  ``--asr_base DIR`` writes a
  KALDI ``wav.scp`` + ``text`` under ``DIR/{train,dev}``: token
  transcripts over the CTC dict's characters, the base pretraining's
  corpus (``run_ctc*.sh --trainbase true``);
* ``speech_commands`` (Google Speech Commands v1): one directory a word
  (the 10 commands, ``OTHER_WORDS`` and ``_background_noise_``) of 1 s
  wavs named ``<speaker>_nohash_<n>.wav``, and ``validation_list.txt``
  and ``testing_list.txt`` naming the dev and test files
  (``<word>/<file>.wav``); the noise files are in neither list.

The audio follows the tone-keyword convention of
``examples/synthetic_ctc/local/gen_data_torch.py``: a word or character
is a tone of its own (pitch, level and duration jittered, over a noise
floor), so a keyword is a tone sequence that a model can learn.

    python -m wekws_tpu_torch.tools.public_layouts snips data/local \\
        --train 256 --dev 32 --test 64 --seed 1
    python -m wekws_tpu_torch.tools.public_layouts mobvoi data/local \\
        --ctc_data data --asr_base data/asr_base
    python -m wekws_tpu_torch.tools.public_layouts speech_commands \\
        data/local --train 10 --dev 2 --test 2
"""

import argparse
import json
import os

import numpy as np

SR = 16000
# the Hey Snips keyword as three tones; a filler avoids that run
SNIPS_TONES = {"hey": 700.0, "sni": 1100.0, "ps": 1600.0, "a": 480.0,
               "b": 950.0, "c": 1350.0, "d": 2000.0}
SNIPS_KEYWORD = ("hey", "sni", "ps")
# Mobvoi's keywords by character (the CTC dict's characters first) and
# the characters of the fillers
MOBVOI_TONES = {"嗨": 520.0, "小": 820.0, "问": 1160.0, "你": 1480.0,
                "好": 1860.0, "今": 2250.0, "天": 2650.0, "气": 3050.0,
                "我": 640.0, "们": 1000.0, "去": 1320.0, "吧": 2450.0}
MOBVOI_KEYWORDS = ("嗨小问", "你好问问")
CTC_CHARS = "嗨小问你好"
FILLER_CHARS = "今天气我们去吧"
COMMANDS = ("yes", "no", "up", "down", "left", "right", "on", "off",
            "stop", "go")
OTHER_WORDS = ("bed", "bird", "cat")
COMMAND_TONES = (450.0, 700.0, 1050.0, 1500.0, 2100.0)
NOISE_FILES = 2  # in the train split: the lists never name them


def render(rng, freqs, lead=0.12, tail=0.12):
    """A tone per frequency (pitch +-4%, level 0.2-0.4, 160-240 ms, gaps
    under 40 ms) over a 0.02 noise floor: float32 in [-1, 1]."""
    pieces = [0.02 * rng.standard_normal(int(SR * lead))]
    for f0 in freqs:
        f = f0 * (1 + 0.04 * rng.standard_normal())
        d = int(SR * (0.16 + 0.08 * rng.random()))
        a = 0.2 + 0.2 * rng.random()
        pieces.append(a * np.sin(2 * np.pi * f * np.arange(d) / SR)
                      + 0.02 * rng.standard_normal(d))
        pieces.append(0.02 * rng.standard_normal(int(SR * 0.04
                                                     * rng.random())))
    pieces.append(0.02 * rng.standard_normal(int(SR * tail)))
    return np.concatenate(pieces).astype(np.float32)


def write_wave(path, wave):
    from wekws_tpu_torch.data.audio import write_wav

    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_wav(path, wave, SR)


def random_sequence(rng, symbols, avoid, lo=2, hi=6):
    """``lo``..``hi`` symbols drawn from ``symbols``, holding none of the
    runs in ``avoid`` (each a sequence of symbols)."""
    while True:
        seq = [symbols[int(i)] for i in rng.integers(0, len(symbols),
                                                     int(rng.integers(lo,
                                                                      hi + 1)))]
        text = "|".join(seq)
        if not any("|".join(a) in text for a in avoid):
            return seq


def with_keyword(rng, keyword, symbols, pad=2):
    """``keyword`` with up to ``pad`` filler symbols on each side."""
    left = [symbols[int(i)] for i in rng.integers(0, len(symbols),
                                                  int(rng.integers(0, pad + 1)))]
    right = [symbols[int(i)] for i in rng.integers(0, len(symbols),
                                                   int(rng.integers(0, pad + 1)))]
    return left + list(keyword) + right


def speaker(rng):
    return "".join(f"{int(v):x}" for v in rng.integers(0, 16, 8))


def write_snips(root, counts, rng):
    """Half of each split the keyword."""
    fillers = [s for s in SNIPS_TONES if s not in SNIPS_KEYWORD]
    for split, n in counts.items():
        entries = []
        for i in range(n):
            hot = i % 2 == 0
            seq = (with_keyword(rng, SNIPS_KEYWORD, fillers, 1) if hot
                   else random_sequence(rng, list(SNIPS_TONES),
                                        [SNIPS_KEYWORD]))
            wave = render(rng, [SNIPS_TONES[s] for s in seq])
            uid = f"{speaker(rng)}-{split}-{i:05d}"
            rel = f"audio_files/{uid}.wav"
            write_wave(os.path.join(root, rel), wave)
            entries.append({"duration": round(len(wave) / SR, 4),
                            "worker_id": speaker(rng),
                            "audio_file_path": rel, "id": uid,
                            "is_hotword": int(hot)})
        with open(os.path.join(root, f"{split}.json"), "w") as f:
            json.dump(entries, f, indent=1)


def mobvoi_utterance(rng, keyword_id):
    """(characters, wave) of a keyword (0, 1) or a filler (-1)."""
    if keyword_id >= 0:
        chars = with_keyword(rng, MOBVOI_KEYWORDS[keyword_id],
                             FILLER_CHARS, 1)
    else:
        chars = random_sequence(rng, FILLER_CHARS + CTC_CHARS,
                                MOBVOI_KEYWORDS, 2, 5)
    return "".join(chars), render(rng, [MOBVOI_TONES[c] for c in chars])


def write_mobvoi(root, counts, rng, ctc_data=None):
    """A quarter of each split each keyword, half fillers."""
    wavs = os.path.join(root, "mobvoi_hotword_dataset")
    res = os.path.join(root, "mobvoi_hotword_dataset_resources")
    os.makedirs(res, exist_ok=True)
    for split, n in counts.items():
        rows, lists = [], {"p": [], "n": []}
        for i in range(n):
            kid = (0, -1, 1, -1)[i % 4]
            chars, wave = mobvoi_utterance(rng, kid)
            spk = speaker(rng)
            utt = f"{spk}{i:05d}{split[:2]}"
            write_wave(os.path.join(wavs, f"{utt}.wav"), wave)
            lists["p" if kid >= 0 else "n"].append(
                {"utt_id": utt, "speaker_id": spk, "keyword_id": kid})
            rows.append((utt, kid, chars))
        for prefix, entries in lists.items():
            with open(os.path.join(res, f"{prefix}_{split}.json"), "w") as f:
                json.dump(entries, f, indent=1)
        if ctc_data is not None:
            d = os.path.join(ctc_data, split)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "wav.scp"), "w",
                      encoding="utf-8") as f_wav, \
                 open(os.path.join(d, "text"), "w",
                      encoding="utf-8") as f_text:
                for utt, _, chars in rows:
                    path = os.path.abspath(os.path.join(wavs, f"{utt}.wav"))
                    f_wav.write(f"{utt} {path}\n")
                    f_text.write(f"{utt} {chars}\n")


def write_asr_base(root, counts, rng):
    """KALDI ``wav.scp`` + ``text`` (space-separated tokens over the CTC
    dict's characters, a filler character now and then) under
    ``root``/{train,dev}."""
    symbols = CTC_CHARS * 3 + FILLER_CHARS
    for split, n in counts.items():
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "wav.scp"), "w", encoding="utf-8") as f_wav, \
             open(os.path.join(d, "text"), "w", encoding="utf-8") as f_text:
            for i in range(n):
                chars = [symbols[int(j)] for j in rng.integers(
                    0, len(symbols), int(rng.integers(2, 7)))]
                path = os.path.abspath(os.path.join(d, "wav",
                                                    f"base_{split}_{i}.wav"))
                write_wave(path, render(rng, [MOBVOI_TONES[c]
                                              for c in chars]))
                f_wav.write(f"base_{split}_{i} {path}\n")
                f_text.write(f"base_{split}_{i} {' '.join(chars)}\n")


def command_wave(rng, word):
    """1 s: the word's two tones (a pair of its own) at a random offset;
    a background noise file is noise alone."""
    if word == "_background_noise_":
        wave = 0.05 * rng.standard_normal(SR)
        return np.convolve(wave, [1.0, -0.5], mode="same").astype(np.float32)
    w = (COMMANDS + OTHER_WORDS).index(word)
    n = len(COMMAND_TONES)
    tones = [COMMAND_TONES[w % n], COMMAND_TONES[(w // n + w + 1) % n]]
    body = render(rng, tones, lead=0.02 + 0.2 * rng.random(), tail=0.0)
    wave = 0.02 * rng.standard_normal(SR).astype(np.float32)
    wave[:min(len(body), SR)] = body[:SR]
    return wave


def write_speech_commands(root, counts, rng):
    """``counts[split]`` files a word in each split, NOISE_FILES in
    ``_background_noise_``."""
    out = {"train": [], "dev": [], "test": []}
    for word in COMMANDS + OTHER_WORDS:
        for split, n in counts.items():
            for _ in range(n):
                name = f"{speaker(rng)}_nohash_{int(rng.integers(0, 5))}.wav"
                while os.path.exists(os.path.join(root, word, name)):
                    name = f"{speaker(rng)}_nohash_0.wav"
                write_wave(os.path.join(root, word, name),
                           command_wave(rng, word))
                out[split].append(f"{word}/{name}")
    for i in range(NOISE_FILES):
        name = f"noise_{i}.wav"
        write_wave(os.path.join(root, "_background_noise_", name),
                   command_wave(rng, "_background_noise_"))
        out["train"].append(f"_background_noise_/{name}")
    for split, listed in (("dev", "validation_list.txt"),
                          ("test", "testing_list.txt")):
        with open(os.path.join(root, listed), "w") as f:
            f.write("".join(f"{rel}\n" for rel in out[split]))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="write a miniature corpus in a public dataset's layout")
    parser.add_argument("layout", choices=["snips", "mobvoi",
                                           "speech_commands"])
    parser.add_argument("out_dir", help="the download directory to write")
    parser.add_argument("--train", type=int, default=32,
                        help="utterances (speech_commands: a word)")
    parser.add_argument("--dev", type=int, default=12)
    parser.add_argument("--test", type=int, default=16)
    parser.add_argument("--seed", type=int, default=20261018)
    parser.add_argument("--ctc_data", default=None,
                        help="mobvoi: also write wav.scp + character text "
                             "under DIR/{train,dev,test}")
    parser.add_argument("--asr_base", default=None,
                        help="mobvoi: also write the base pretraining "
                             "corpus under DIR/{train,dev}")
    parser.add_argument("--base_train", type=int, default=32)
    parser.add_argument("--base_dev", type=int, default=8)
    args = parser.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    counts = {"train": args.train, "dev": args.dev, "test": args.test}
    os.makedirs(args.out_dir, exist_ok=True)
    if args.layout == "snips":
        write_snips(args.out_dir, counts, rng)
    elif args.layout == "mobvoi":
        write_mobvoi(args.out_dir, counts, rng, args.ctc_data)
        if args.asr_base is not None:
            write_asr_base(args.asr_base, {"train": args.base_train,
                                           "dev": args.base_dev}, rng)
    else:
        write_speech_commands(args.out_dir, counts, rng)
    print(f"wrote the {args.layout} layout under {args.out_dir} "
          f"({counts}, seed {args.seed})")


if __name__ == "__main__":
    main()
