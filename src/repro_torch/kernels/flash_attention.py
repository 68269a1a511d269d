"""Flash attention: plain PyTorch version and CUDA wrapper.

Port of ``repro.kernels.flash_attention.flash_attention`` (the TPU
prefill kernel): online-softmax attention over flattened heads, fp32
running statistics, GQA by the kv-row map ``b // G``, causal masking on
absolute positions (``q_offset``) and trailing keys masked by ``kv_len``.
The CUDA kernels are in ``csrc/flash_attention.cu``; unlike the reference,
``q_offset`` and ``kv_len`` are run-time arguments.  Two variants, chosen
by ``flash_variant`` from the dtype and head dims: "mma" (bf16 tensor
cores; bf16 with hd and hd_v multiples of 16) and "simt" (fp32 CUDA
cores; float32, or other head dims).  Each head dim goes up to 256
(``MAX_HEAD_DIM``): MLA's q/k of 192 against v of 128 (DeepSeek-V2) runs
on the tensor cores; past 256 a launch raises.

Layout contract: q (BH_q, Sq, hd); k (BH_kv, L, hd); v (BH_kv, L, hd_v);
returns (BH_q, Sq, hd_v) in q's dtype.  The wrapper takes the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises;
for meta tensors (the dry-run) it plans a call (``kernels/planned.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import planned as _planned
from repro_torch.kernels import ref as _ref

MAX_HEAD_DIM = 256                 # the kernels' largest hd / hd_v
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODE = {"simt": 0, "mma": 1}

# kernel launches on the CUDA path (the plain CPU path does not count):
# every launch, those of the tensor-core variant and the causal ones
launches = 0
launches_mma = 0
launches_causal = 0


def flash_variant(dtype, hd: int, hd_v: int) -> str:
    """The kernel variant for q/k/v of ``dtype`` and head dims (hd, hd_v):
    "mma" (bf16 tensor cores) for bf16 with both head dims multiples of 16,
    else "simt" (fp32 CUDA cores).  Raises for a head dim past
    MAX_HEAD_DIM, which neither kernel takes."""
    if not (0 < hd <= MAX_HEAD_DIM and 0 < hd_v <= MAX_HEAD_DIM):
        raise ValueError(f"head dims ({hd}, {hd_v}): the flash kernels take "
                         f"1 to {MAX_HEAD_DIM} each")
    if dtype == torch.bfloat16 and hd % 16 == 0 and hd_v % 16 == 0:
        return "mma"
    return "simt"


def flash_attention_plain(q, k, v, *, causal=True, q_offset=0, kv_len=None):
    """Plain version: the full masked softmax with fp32 scores (the
    reference oracle ``kernels/ref.flash_attention_ref``; any device)."""
    return _ref.flash_attention_ref(q, k, v, causal=causal,
                                    q_offset=q_offset, kv_len=kv_len)


@functools.lru_cache(maxsize=1)
def _library():
    """The built library and its launcher with C argument types declared."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, i,
                   i, p]
    fn.restype = i
    return lib, fn


def _launch(q, k, v, causal, q_offset, kv_len):
    global launches, launches_mma, launches_causal
    BHq, Sq, hd = q.shape
    BHkv, L, hdk = k.shape
    hdv = v.shape[-1]
    if hdk != hd or tuple(v.shape[:2]) != (BHkv, L) or BHq % BHkv:
        raise ValueError(f"bad attention shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("q/k/v must be contiguous on one CUDA device")
    if not 0 <= kv_len <= L:
        raise ValueError(f"kv_len {kv_len} outside [0, {L}]")
    variant = flash_variant(q.dtype, hd, hdv)
    if variant == "mma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core flash kernel needs 16-byte aligned "
                         "q/k/v")
    out = torch.empty((BHq, Sq, hdv), dtype=q.dtype, device=q.device)
    lib, fn = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], _VARIANT_CODE[variant], BHq, BHkv, Sq, L,
            hd, hdv, 1.0 / hd ** 0.5, int(q_offset), int(kv_len),
            int(causal), stream)
    _build.check(lib, "flash_attention_error_string", rc, "flash_attention")
    launches += 1
    launches_mma += variant == "mma"
    launches_causal += bool(causal)
    return out


def flash_attention(q, k, v, *, causal=True, q_offset=None, kv_len=None):
    """Blocked attention over flattened heads (see module docstring).
    ``q_offset`` (int) shifts the causal mask for chunked prefill;
    ``kv_len`` (int, default L) masks trailing keys."""
    q_offset = 0 if q_offset is None else int(q_offset)
    L = k.shape[1]
    kv_len = L if kv_len is None else int(kv_len)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "meta":
        return _plan(q, k, v, causal, q_offset, kv_len)
    return _launch(q, k, v, causal, q_offset, kv_len)


def _plan(q, k, v, causal, q_offset, kv_len):
    """The planned call on meta tensors (``kernels/planned.py``): the
    launch's checks and output, no launch."""
    BHq, Sq, hd = q.shape
    BHkv, L, hdk = k.shape
    hdv = v.shape[-1]
    if hdk != hd or tuple(v.shape[:2]) != (BHkv, L) or BHq % BHkv:
        raise ValueError(f"bad attention shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if not 0 <= kv_len <= L:
        raise ValueError(f"kv_len {kv_len} outside [0, {L}]")
    variant = flash_variant(q.dtype, hd, hdv)
    out = torch.empty((BHq, Sq, hdv), dtype=q.dtype, device=q.device)
    pairs = _planned.causal_pairs(Sq, L, q_offset, kv_len, causal)
    _planned.add("flash_attention", 2 * BHq * pairs * (hd + hdv),
                 (q, k, v), (out,), flash_attention_mma=variant == "mma",
                 flash_attention_causal=causal)
    return out
