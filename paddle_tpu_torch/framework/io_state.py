"""``paddle.save`` / ``paddle.load`` (the counterpart of
``paddle_tpu/framework/io_state.py``), in the JAX package's pickle
format, so each package loads the other's ``.pdparams`` and ``.pdopt``.

A tensor is saved as ``{"__tensor__": True, "data": ndarray, "name",
"stop_gradient"}`` (``name`` its key in the enclosing dict); containers
and Python values as they are.  numpy has no bfloat16 of its own, so a
bf16 tensor's ``data`` is its bits as ``uint16`` and the leaf carries
``"dtype": "bfloat16"``, which :func:`load` reads back as bf16.  The
JAX package pickles bf16 as ``ml_dtypes.bfloat16`` arrays; :func:`load`
reads those where ``ml_dtypes`` is installed and otherwise refuses them
by name.  The JAX package reads a port bf16 leaf as its ``uint16`` bits:
only f32 and the other numpy types cross both ways.

:func:`load` unpickles only numpy arrays, numpy scalars and dtypes,
``OrderedDict``, ``ml_dtypes``' bf16 and fp8 types and builtin
containers, each by its exact name; any other class or function, a
numpy one too, raises ``pickle.UnpicklingError``.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]

_BF16 = "bfloat16"


def _to_saveable(obj, name=None):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        leaf = {"__tensor__": True, "name": name,
                "stop_gradient": not obj.requires_grad}
        if t.dtype == torch.bfloat16:
            leaf["data"] = t.view(torch.int16).numpy().view(np.uint16)
            leaf["dtype"] = _BF16
        else:
            leaf["data"] = t.numpy()
        return leaf
    if isinstance(obj, dict):
        return {k: _to_saveable(v, k) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_saveable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _leaf(obj, return_numpy):
    data = obj["data"]
    if obj.get("dtype") == _BF16:                 # the port's bf16 bits
        t = torch.from_numpy(np.array(data).view(np.int16)).view(
            torch.bfloat16)
        return t.float().numpy() if return_numpy else t
    if data.dtype.name == _BF16:                  # ml_dtypes, the JAX way
        if return_numpy:
            return data
        return torch.from_numpy(np.array(data).view(np.int16)).view(
            torch.bfloat16)
    if return_numpy:
        return data
    return torch.from_numpy(np.array(data))


def _from_saveable(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            return _leaf(obj, return_numpy)
        return {k: _from_saveable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_saveable(v, return_numpy) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` (a state dict, nested containers, a tensor; an
    object with ``state_dict()`` saves that) to ``path``, making its
    directory."""
    if hasattr(obj, "state_dict") and not isinstance(obj, dict):
        obj = obj.state_dict()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


class _SafeUnpickler(pickle.Unpickler):
    _ALLOWED = {
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy.core.numeric", "_frombuffer"),       # pickle protocol 5
        ("numpy._core.numeric", "_frombuffer"),
        ("collections", "OrderedDict"),
        ("ml_dtypes", "bfloat16"),
        ("ml_dtypes", "float8_e4m3fn"),
        ("ml_dtypes", "float8_e5m2"),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            try:
                return super().find_class(module, name)
            except ImportError as e:
                raise pickle.UnpicklingError(
                    f"the file holds {module}.{name} arrays (the JAX "
                    f"package's bf16 / fp8), and {module} is not "
                    f"installed here") from e
        raise pickle.UnpicklingError(
            f"paddle_tpu_torch.load refuses to unpickle {module}.{name}; "
            "checkpoints may only contain arrays and containers")


def load(path, return_numpy=False, **configs):
    """What :func:`save` (or the JAX package's ``save``) wrote: tensors
    on the CPU (``return_numpy``: numpy arrays, bf16 as f32), containers
    and values as saved."""
    with open(path, "rb") as f:
        obj = _SafeUnpickler(f).load()
    return _from_saveable(obj, return_numpy=return_numpy)
