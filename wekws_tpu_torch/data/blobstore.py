"""Random-access blob store for augmentation corpora (noise / RIR).

Copy of wekws_tpu/data/blobstore.py, the JAX package's replacement of
the reference wekws's LMDB source (wekws/dataset/lmdb_data.py): a
single packed ``.blob`` data file plus a ``.idx`` text index (``key
offset size`` per line).  No external dependency, mmap-friendly,
trivially shardable.  An lmdb reader shim is provided for drop-in reuse of existing corpora
when the lmdb package is present.
"""

import mmap
import os
import random
from typing import List, Tuple


class BlobWriter:
    def __init__(self, path: str):
        self.path = path
        self._data = open(path + ".blob", "wb")
        self._index = open(path + ".idx", "w", encoding="utf8")
        self._offset = 0

    def put(self, key: str, value: bytes) -> None:
        self._data.write(value)
        self._index.write(f"{key} {self._offset} {len(value)}\n")
        self._offset += len(value)

    def close(self) -> None:
        self._data.close()
        self._index.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BlobData:
    """Read-only random-access store; API mirrors the reference's
    LmdbData (``random_one() -> (key, bytes)``)."""

    def __init__(self, path: str, seed: int = None):
        self.path = path
        self.entries: List[Tuple[str, int, int]] = []
        with open(path + ".idx", "r", encoding="utf8") as f:
            for line in f:
                key, offset, size = line.rsplit(" ", 2)
                self.entries.append((key, int(offset), int(size)))
        # file/mmap opened lazily so the store pickles into spawn-mode
        # DataLoader workers (each worker maps the file itself)
        self._file = None
        self._mm = None
        self._rng = random.Random(seed)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_file"] = None
        state["_mm"] = None
        return state

    def _ensure_open(self):
        if self._mm is None:
            self._file = open(self.path + ".blob", "rb")
            self._mm = mmap.mmap(
                self._file.fileno(), 0, access=mmap.ACCESS_READ
            )

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, i: int) -> Tuple[str, bytes]:
        self._ensure_open()
        key, offset, size = self.entries[i]
        return key, self._mm[offset : offset + size]

    def random_one(self) -> Tuple[str, bytes]:
        return self.get(self._rng.randrange(len(self.entries)))

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._file.close()
            self._mm = self._file = None


class LmdbData:  # pragma: no cover - optional compat shim
    """Reader for reference-produced lmdb corpora (requires lmdb)."""

    def __init__(self, path: str, seed: int = None):
        import lmdb
        import pickle

        self.env = lmdb.open(
            path, readonly=True, lock=False, readahead=False, meminit=False
        )
        with self.env.begin(write=False) as txn:
            self.keys = pickle.loads(txn.get(b"__keys__"))
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.keys)

    def random_one(self):
        key = self._rng.choice(self.keys)
        with self.env.begin(write=False) as txn:
            data = txn.get(key)
        return key.decode(), data


def open_store(path: str, seed: int = None):
    """Open a blob store or an lmdb directory, dispatching on layout."""
    if os.path.isdir(path):
        return LmdbData(path, seed)
    return BlobData(path, seed)
