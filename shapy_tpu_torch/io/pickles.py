"""Reading the reference's pickled files without the libraries that wrote
them.

* :func:`load_torch_file`: a ``torch.save`` file (a Lightning checkpoint,
  the reference's ``{'model', 'hparams'}`` polynomial) on the CPU.
* :func:`load_pickle`: a database the reference wrote with ``joblib``
  (``{dataset}_{gender}_{split}.pt``, ``modeldata_for_a2s_{gender}.pt``).
  With ``joblib`` installed it reads the file; without it (the card's
  machine has none) :class:`_ArrayUnpickler` reads plain pickles and
  joblib's uncompressed format, whose arrays are ``NumpyArrayWrapper``
  records followed by the array's bytes in the stream (after a padding
  byte and its padding, from joblib 1.2 on). A compressed file, or joblib's
  pre-0.10 format of arrays in files of their own, raises a ``ValueError``
  that names the file and says it needs ``joblib``.
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np


def load_torch_file(path: str) -> Any:
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


class _ArrayRecord:
    """Stands in for ``joblib.numpy_pickle.NumpyArrayWrapper``: its state
    (shape, order, dtype, alignment) arrives by BUILD."""


class _NeedsJoblib(pickle.UnpicklingError):
    pass


class _ArrayUnpickler(pickle._Unpickler):
    """The pure-Python unpickler, its BUILD opcode taught to read the
    array that follows a joblib array record."""

    dispatch = pickle._Unpickler.dispatch.copy()

    def __init__(self, file):
        super().__init__(file)
        self.file_handle = file

    def find_class(self, module, name):
        if module == "joblib.numpy_pickle" and name == "NumpyArrayWrapper":
            return _ArrayRecord
        if module.startswith("joblib"):
            raise _NeedsJoblib(f"{module}.{name}")
        return super().find_class(module, name)

    def load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], _ArrayRecord):
            self.stack.append(self._read_array(self.stack.pop()))

    dispatch[pickle.BUILD[0]] = load_build

    def _read_array(self, rec: _ArrayRecord) -> np.ndarray:
        f = self.file_handle
        dtype = np.dtype(rec.dtype)
        if dtype.hasobject:
            return pickle.load(f)
        if getattr(rec, "numpy_array_alignment_bytes", None) is not None:
            pad = int.from_bytes(f.read(1), "little")
            f.read(pad)
        shape = tuple(int(s) for s in rec.shape)
        count = int(np.prod(shape, dtype=np.int64))
        data = f.read(count * dtype.itemsize)
        if len(data) != count * dtype.itemsize:
            raise EOFError("truncated array data")
        array = np.frombuffer(data, dtype=dtype, count=count).copy()
        if rec.order == "F":
            array = array.reshape(shape[::-1]).transpose()
        else:
            array = array.reshape(shape)
        if not array.dtype.isnative:
            array = array.astype(array.dtype.newbyteorder("="))
        return array


def _load_without_joblib(path: str) -> Any:
    with open(path, "rb") as f:
        head = f.read(1)
        f.seek(0)
        if head != b"\x80":
            raise ValueError(f"{path}: not a pickle or an uncompressed "
                             "joblib file; reading it needs joblib")
        try:
            return _ArrayUnpickler(f).load()
        except _NeedsJoblib as exc:
            raise ValueError(f"{path}: holds {exc}, a joblib format that "
                             "needs joblib") from exc


def load_pickle(path: str) -> Any:
    """A joblib or pickle file: with ``joblib`` where it is installed,
    else with the reader above."""
    try:
        import joblib
    except ImportError:
        return _load_without_joblib(path)
    return joblib.load(path)
