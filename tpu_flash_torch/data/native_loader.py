"""ctypes bindings of the C++ batch ring, counterpart of
``tpu_flash/data/native_loader.py`` over the port's own copy of its source,
``tpu_flash_torch/native/collate.cpp``.

The library is built at first use with ``g++ -O3 -std=c++17 -shared -fPIC
... -lpthread`` into the git-ignored ``tpu_flash_torch/native/_build/``,
named by a digest of the source.  Where the build fails this raises
``NativeUnavailable``: the port's app does not go on with the Python
collate as the JAX app does, since a run that asked for the loader would
then quietly measure another one.

* ``tokenize_corpus``: the corpus tokenized once, as flat id arrays;
* ``pack_batch`` / ``pack_batch_packed``: one batch packed natively, the
  twins of ``mt.collate_batch`` and ``mt.collate_packed(fixed_rows=)``;
* ``NativeBatchLoader``: worker threads packing shuffled batches into a
  bounded ring; ``next()`` returns numpy batches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE, "collate.cpp")
BUILD_DIR = os.path.join(_NATIVE, "_build")


class NativeUnavailable(RuntimeError):
    pass


_lib = None
_lock = threading.Lock()


def _build_and_load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        so_path = os.path.join(BUILD_DIR, f"libcollate-{digest}.so")
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so_path}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC,
                   "-o", tmp, "-lpthread"]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
            except (subprocess.CalledProcessError, FileNotFoundError) as e:
                detail = getattr(e, "stderr", b"") or b""
                raise NativeUnavailable(
                    f"building {_SRC} failed: {e} "
                    f"{detail.decode(errors='replace')[-2000:]}") from e
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.loader_create.restype = p
        lib.loader_create.argtypes = [p, p, p, p, i64, i32, i32, i32, i32,
                                      ctypes.c_uint64, i32, i32, i32, i32]
        lib.loader_next.restype = i32
        lib.loader_next.argtypes = [p] * 4
        lib.loader_next_packed.restype = i32
        lib.loader_next_packed.argtypes = [p] * 6
        lib.loader_dropped.restype = i64
        lib.loader_dropped.argtypes = [p]
        lib.loader_destroy.argtypes = [p]
        lib.pack_batch.argtypes = [p] * 5 + [i32] * 4 + [p] * 3
        lib.pack_batch_packed.argtypes = [p] * 5 + [i32] * 4 + [p] * 5
        _lib = lib
        return lib


def _flatten(token_lists):
    """Lists of ids -> (flat int32, offsets int64)."""
    offsets = np.zeros(len(token_lists) + 1, np.int64)
    offsets[1:] = np.cumsum([len(t) for t in token_lists])
    flat = np.empty(offsets[-1], np.int32)
    for i, t in enumerate(token_lists):
        flat[offsets[i]:offsets[i + 1]] = t
    return flat, offsets


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def tokenize_corpus(examples, src_key, tgt_key, tokenizer):
    """Tokenize once: returns (src_flat, src_off, tgt_flat, tgt_off)."""
    src = [tokenizer(f"{ex[src_key]}<eos_{src_key}>")["input_ids"]
           for ex in examples]
    tgt = [tokenizer(f"{ex[tgt_key]}<eos_{tgt_key}>")["input_ids"]
           for ex in examples]
    return _flatten(src) + _flatten(tgt)


def _batch(shape, packed: bool) -> dict[str, np.ndarray]:
    out = {"input_ids": np.empty(shape, np.int32),
           "labels": np.empty(shape, np.int32),
           "label_token_weights": np.empty(shape, np.float32)}
    if packed:
        out["segment_ids"] = np.empty(shape, np.int32)
        out["positions"] = np.empty(shape, np.int32)
    return out


def _corpus(src_flat, src_off, tgt_flat, tgt_off, indices=None):
    """The arrays as the C code reads them (contiguous int32 ids, int64
    offsets and indices), the indices checked against the corpus."""
    arrays = [np.ascontiguousarray(src_flat, np.int32),
              np.ascontiguousarray(src_off, np.int64),
              np.ascontiguousarray(tgt_flat, np.int32),
              np.ascontiguousarray(tgt_off, np.int64)]
    if len(arrays[1]) != len(arrays[3]):
        raise ValueError("source and target offsets differ in length")
    if indices is not None:
        indices = np.ascontiguousarray(indices, np.int64)
        if len(indices) and not (0 <= indices.min()
                                 and indices.max() < len(arrays[1]) - 1):
            raise IndexError("an index lies outside the corpus")
        arrays.append(indices)
    return arrays


def pack_batch(src_flat, src_off, tgt_flat, tgt_off, indices, max_len,
               pad_id, mask_padding=False):
    """The examples at ``indices`` packed natively (``collate_batch``)."""
    lib = _build_and_load()
    arrays = _corpus(src_flat, src_off, tgt_flat, tgt_off, indices)
    out = _batch((len(arrays[4]), max_len), packed=False)
    lib.pack_batch(*(_ptr(a) for a in arrays), len(arrays[4]), max_len,
                   pad_id, int(mask_padding),
                   *(_ptr(a) for a in out.values()))
    return out


def pack_batch_packed(src_flat, src_off, tgt_flat, tgt_off, indices, max_len,
                      pad_id, fixed_rows):
    """The examples at ``indices`` sequence-packed natively
    (``collate_packed(fixed_rows=)``, the same bytes)."""
    lib = _build_and_load()
    arrays = _corpus(src_flat, src_off, tgt_flat, tgt_off, indices)
    out = _batch((fixed_rows, max_len), packed=True)
    lib.pack_batch_packed(*(_ptr(a) for a in arrays), len(arrays[4]),
                          max_len, pad_id, fixed_rows,
                          *(_ptr(a) for a in out.values()))
    return out


class NativeBatchLoader:
    """Worker threads packing shuffled epoch batches into a ring; ``next()``
    (or iteration) gives the next batch."""

    def __init__(self, src_flat, src_off, tgt_flat, tgt_off, *, max_len,
                 pad_id, batch_size, mask_padding=False, seed=0,
                 n_threads=2, ring_capacity=8, packed=False, fixed_rows=0):
        self._lib = _build_and_load()
        self.batch_size = batch_size
        self.max_len = max_len
        self.packed = packed
        self.fixed_rows = fixed_rows
        if packed and fixed_rows < 1:
            raise ValueError("packed mode requires fixed_rows >= 1")
        # loader_create copies the corpus
        arrays = _corpus(src_flat, src_off, tgt_flat, tgt_off)
        self._handle = self._lib.loader_create(
            *(_ptr(a) for a in arrays), len(arrays[1]) - 1, max_len, pad_id,
            batch_size, int(mask_padding), seed, n_threads, ring_capacity,
            int(packed), fixed_rows)
        if not self._handle:
            raise NativeUnavailable("loader_create returned NULL")

    def next(self):
        if self.packed:
            out = _batch((self.fixed_rows, self.max_len), packed=True)
            n = self._lib.loader_next_packed(
                self._handle, *(_ptr(a) for a in out.values()))
        else:
            out = _batch((self.batch_size, self.max_len), packed=False)
            n = self._lib.loader_next(self._handle,
                                      *(_ptr(a) for a in out.values()))
        if n == 0:
            raise StopIteration
        return out

    def __iter__(self):
        return self

    __next__ = next

    def dropped(self) -> int:
        """Packed mode: examples dropped to full batches so far."""
        if not self._handle:
            return 0
        return int(self._lib.loader_dropped(self._handle))

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
