"""Chunked bulk file writes.

numpy's save/savez hand the whole array buffer to one write() syscall; on
hosts whose dirty-page throttle stalls large single writes, slices of <= 1
MB avoid the stall. Every bulk writer here goes through this wrapper. (The
C fast path has its own fwrite_chunked — native/fastxpack.cpp.) Whether the
slicing still pays on current hosts is unmeasured.
"""

from __future__ import annotations

import io
from typing import BinaryIO

CHUNK = 1 << 20


class ChunkedWriter(io.RawIOBase):
    """File-object proxy that slices every write into <= CHUNK-byte ops."""

    def __init__(self, raw: BinaryIO):
        self._raw = raw

    def write(self, data) -> int:
        mv = memoryview(data).cast("B")
        n = len(mv)
        for off in range(0, n, CHUNK):
            self._raw.write(mv[off : off + CHUNK])
        return n

    def writable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return self._raw.seekable()

    def seek(self, pos, whence=0) -> int:
        return self._raw.seek(pos, whence)

    def tell(self) -> int:
        return self._raw.tell()

    def flush(self) -> None:
        self._raw.flush()

    def close(self) -> None:
        if not self.closed:
            try:
                self._raw.close()
            finally:
                super().close()


def np_save_chunked(path: str, arr) -> None:
    import numpy as np

    with open(path, "wb") as f:
        np.save(ChunkedWriter(f), arr)


def np_savez_chunked(path: str, compressed: bool = False, **arrays) -> None:
    import numpy as np

    save = np.savez_compressed if compressed else np.savez
    with open(path, "wb") as f:
        save(ChunkedWriter(f), **arrays)
