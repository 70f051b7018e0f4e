"""Build a blob store of wav bytes from a Kaldi wav.scp.

Port of wekws_tpu/tools/make_blob.py (the reference's
tools/make_lmdb.py, which packs noise and RIR corpora into lmdb): a
flat ``<out>.blob`` + ``<out>.idx`` pair (``data/blobstore.py``) that
``BlobData`` reads.

Usage:
    python -m wekws_tpu_torch.tools.make_blob in.scp out_store
    # -> out_store.blob, out_store.idx
"""

import argparse
import sys

from wekws_tpu_torch.data.blobstore import BlobWriter


def make_blob(scp_file: str, out_path: str) -> int:
    """Pack ``key path`` scp lines into a blob store.  Returns count."""
    n = 0
    with BlobWriter(out_path) as writer:
        with open(scp_file, "r", encoding="utf8") as fin:
            for line_no, line in enumerate(fin, 1):
                arr = line.strip().split()
                if not arr:
                    continue
                if len(arr) != 2:
                    raise ValueError(f"{scp_file}:{line_no}: expected 'key "
                                     f"path', got {line.strip()!r}")
                key, wav = arr
                with open(wav, "rb") as f:
                    writer.put(key, f.read())
                n += 1
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="pack wav files into a blob store (lmdb analog)"
    )
    parser.add_argument("in_scp_file", help="wav.scp: '<key> <path>' lines")
    parser.add_argument("out_store", help="output prefix (.blob/.idx)")
    args = parser.parse_args(argv)
    n = make_blob(args.in_scp_file, args.out_store)
    print(f"packed {n} entries -> {args.out_store}.blob", file=sys.stderr)


if __name__ == "__main__":
    main()
