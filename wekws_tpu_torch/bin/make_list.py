"""data.list CLI: ``wav.scp`` + ``text`` -> wav durations -> JSONL list.

The reference wekws's tools/wav_to_duration.sh and tools/make_list.py
in one step, over the port's ``tools/durations.py`` and
``tools/make_list.py``: the duration file is written from the wavs when
it does not exist yet, then the list joins the three tables.  Host
work only.

    python -m wekws_tpu_torch.bin.make_list wav.scp text wav.dur data.list
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="make a data list")
    parser.add_argument("wav_scp")
    parser.add_argument("text")
    parser.add_argument("duration_file",
                        help="key duration lines; written if missing")
    parser.add_argument("out_list")
    args = parser.parse_args(argv)

    from wekws_tpu_torch.tools.durations import wav_durations
    from wekws_tpu_torch.tools.make_list import read_table, make_list

    if not os.path.exists(args.duration_file):
        wav_durations(read_table(args.wav_scp).items(), args.duration_file)
    n = make_list(args.wav_scp, args.text, args.duration_file,
                  args.out_list)
    print(f"{n} utterances -> {args.out_list}")
    return n


if __name__ == "__main__":
    main()
