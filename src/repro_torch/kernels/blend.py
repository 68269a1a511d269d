"""OBU blend: blocked channel shuffle fused with bias and activation —
plain PyTorch version and CUDA wrapper.

Port of ``repro.kernels.blend.blend_shuffle`` (the TPU kernel realizes the
paper's blocked random shuffle, §3.2 method 1, as grid index remapping):

    y[:, block j] = act(x[:, block perm[j]] + bias[block j])

The CUDA kernel is ``csrc/blend_shuffle.cu``: one pass of 16-byte vector
loads and stores where ``block`` and the operands' alignment allow it
(``vector_path``), else one element per thread.  Both versions add the
bias in x's dtype and round silu per op (``apply_activation``), as the
reference does.  ``bias=None`` skips the add (the reference adds zeros:
the same values).  The block permutation lives on the device once per
(permutation, device) — a host-to-device copy per call would make the host
wait for the device.  The wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises; for meta
tensors (the dry-run) it plans a call (``kernels/planned.py``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import planned as _planned
from repro_torch.kernels.photonic_mvm import (_ACT_CODE, _DTYPE_CODE,
                                              apply_activation)

# kernel launches on the CUDA path (the plain CPU path does not count)
launches = 0


def check_blocks(C: int, perm: tuple, block: int) -> None:
    """Validate a blocked shuffle of C channels (the reference's refusals,
    ``blend.py:41-54``)."""
    if block <= 0 or C % block != 0:
        # a ragged channel axis would silently drop the C % block tail
        # columns from every block slice — refuse instead
        raise ValueError(
            f"blend_shuffle needs the channel axis to split into whole "
            f"blocks: C={C} is not a multiple of block={block}")
    if sorted(perm) != list(range(C // block)):
        raise ValueError(f"block_perm must be a permutation of "
                         f"range({C // block}), got {list(perm)}")


def gather_index(perm: tuple, block: int) -> np.ndarray:
    """Source channel of every output channel."""
    p = np.asarray(perm, np.int64)
    return (p[:, None] * block + np.arange(block)[None, :]).reshape(-1)


@functools.lru_cache(maxsize=None)
def _cached_index(perm: tuple, block: int, C: int, device: str):
    """(the gather index, the block permutation) on ``device``, made once
    per key."""
    check_blocks(C, perm, block)
    return (torch.as_tensor(gather_index(perm, block), device=device),
            torch.as_tensor(np.asarray(perm, np.int32), device=device))


def blend_shuffle_plain(x, bias, block_perm, *, block: int,
                        activation: str = "none"):
    """Plain version (any device): a column gather, the bias add in x's
    dtype, then the activation."""
    perm = tuple(int(v) for v in np.asarray(block_perm).reshape(-1))
    idx, _ = _cached_index(perm, int(block), x.shape[-1], str(x.device))
    y = x.index_select(-1, idx)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return apply_activation(y, activation)


def vector_path(block: int, *tensors) -> bool:
    """Whether the kernel takes its 16-byte vector pass: ``block`` a
    multiple of the vector width (16 bytes of the first tensor's dtype: 8
    bf16 or 4 float32) and every tensor given (x, out, bias; None is
    skipped) starting 16-byte aligned.  Else the element pass."""
    width = 16 // tensors[0].element_size()
    return block % width == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors if t is not None)


@functools.lru_cache(maxsize=1)
def _library():
    lib = _build.load("blend_shuffle")
    fn = lib.blend_shuffle
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, i, i, ctypes.c_longlong, i, i, p, p]
    fn.restype = i
    return lib, fn


def _launch(x, bias, perm, block, activation):
    global launches
    if x.ndim != 2:
        raise ValueError(f"need x (M, C), got {tuple(x.shape)}")
    M, C = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not supported (float32/bf16)")
    if bias is not None and (tuple(bias.shape) != (C,)
                             or bias.dtype != x.dtype
                             or bias.device != x.device
                             or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous ({C},) {x.dtype} tensor "
                         f"on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if activation not in _ACT_CODE:
        raise ValueError(f"unsupported blend activation {activation!r}")
    _, dperm = _cached_index(perm, block, C, str(x.device))
    out = torch.empty_like(x)
    lib, fn = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), _DTYPE_CODE[x.dtype],
            bias.data_ptr() if bias is not None else None, dperm.data_ptr(),
            block, _ACT_CODE[activation], M, C,
            int(vector_path(block, x, out, bias)), out.data_ptr(), stream)
    _build.check(lib, "blend_shuffle_error_string", rc, "blend_shuffle")
    launches += 1
    return out


def blend_shuffle(x, bias, block_perm, *, block: int,
                  activation: str = "none"):
    """``y[:, block j] = act(x[:, block perm[j]] + bias[block j])`` for x
    (M, C) float32/bf16, bias (C,) in x's dtype or None, ``block_perm`` a
    permutation of range(C // block).  Refuses ``C % block != 0`` and a
    non-permutation.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    perm = tuple(int(v) for v in np.asarray(block_perm).reshape(-1))
    if x.device.type == "cpu":
        return blend_shuffle_plain(x, bias, perm, block=block,
                                   activation=activation)
    if x.device.type == "meta":
        return _plan(x, bias, perm, int(block), activation)
    return _launch(x, bias, perm, int(block), activation)


def _plan(x, bias, perm, block, activation):
    """The planned call on meta tensors (``kernels/planned.py``): the
    launch's checks and output, no launch; a bias add and an activation
    per element."""
    if x.ndim != 2:
        raise ValueError(f"need x (M, C), got {tuple(x.shape)}")
    M, C = x.shape
    if C % block or sorted(perm) != list(range(C // block)):
        raise ValueError(f"block_perm must permute the {C // block} blocks "
                         f"of {block} channels")
    if activation not in _ACT_CODE:
        raise ValueError(f"unsupported blend activation {activation!r}")
    out = torch.empty_like(x)
    _planned.add("blend_shuffle", 2 * M * C, (x, bias), (out,))
    return out
