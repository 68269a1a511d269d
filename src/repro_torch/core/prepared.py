"""Prepared photonic weight banks — write-once quantization at build time.

Port of ``repro.core.prepared``.  ``PreparedTensor`` is the software image
of a programmed MRR bank: int8 tiles and per-channel gains for both OBU
orientations plus the W0 read-back checksums, derived once by
``Program.build`` and streamed through by every serving step.

  * ``wq``      int8 (..., K, N) — per-output-channel symmetric W8 tiles;
  * ``scale``   f32  (..., N)    — per-output-channel TIA gains;
  * ``wq_t``    int8 (..., K, N) — the same matrix re-quantized per ROW for
                the optical-transpose orientation (same array shape: the
                transposed use reads it as (N', K') = (K, N) with rows as
                output channels);
  * ``scale_t`` f32  (..., K)    — per-row gains of the transposed use;
  * ``w0_colsum`` / ``w0_rowsum_t`` f32 — the offset-decomposition checksums
                of both orientations (paper eq. 6), recomputed by
                :func:`verify_bank`.

Each leaf carries a static ``tag``: the crc32 of the JAX ``keystr`` form of
its parameter path (``['segments']['main']['l0']['mixer']['wq']``), rebuilt
here without JAX so the port's banks carry the reference's identities.

On float32 configs the int8 tiles, gains, checksums and tags are bitwise
equal to the reference's (tested).  On bf16 configs the cast-then-quantize
divide rounds to bf16 here, and XLA could keep that intermediate in f32
inside its fusion; measured on the test configs, no int8 entry differs
(``tests/test_torch_prepared.py`` holds it to that).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.device import torch_dtype

QMAX = 127.0

# Crossbar-matmul weight leaves, by final parameter key.  Only these are
# programmed into banks; everything else stays floating point.  ``table``
# (the embedding gather) is deliberately not prepared.
MATMUL_LEAVES = frozenset({
    "wq", "wk", "wv", "wo",                      # attention projections
    "w_gate", "w_up", "w_down",                  # MLPs + MoE expert banks
    "w_dkv",                                     # MLA down-projection
    "w_in", "w_out",                             # SSM in/out projections
    "w",                                         # unembed / linear adapters
})


# =========================================================================
# canonical W8 quantization
# =========================================================================
def quantize_weight(w: torch.Tensor, qmax: float = QMAX):
    """Per-output-channel symmetric W8 of ``w`` (..., K, N).  Returns
    (wq int8 (..., K, N), scale f32 (..., N)); reductions run over axis -2
    only, so leading stack dims quantize slice-wise."""
    wmax = torch.clamp(w.abs().amax(dim=-2, keepdim=True), min=1e-8)
    w_norm = w / wmax
    wq = torch.clamp(torch.round(w_norm * qmax), -qmax - 1, qmax)
    return wq.to(torch.int8), wmax.squeeze(-2).to(torch.float32)


def quantize_weight_t(w: torch.Tensor, qmax: float = QMAX):
    """Per-ROW symmetric W8 of ``w`` (..., N, K) for the transposed use.
    Returns (wq_t int8 (..., N, K), scale_t f32 (..., N))."""
    wmax = torch.clamp(w.abs().amax(dim=-1), min=1e-8)
    w_norm = w / wmax[..., None]
    wq = torch.clamp(torch.round(w_norm * qmax), -qmax - 1, qmax)
    return wq.to(torch.int8), wmax.to(torch.float32)


def _affine_fma(s: torch.Tensor, qmax: float, offset: float) -> torch.Tensor:
    """``s / (2*qmax) + offset`` as the reference's compiled prepare cell
    evaluates it: XLA contracts it into fma(s, f32(1/(2*qmax)), offset), one
    rounding.  The integer-valued sum ``s`` times the f32 reciprocal is
    exact in float64, so rounding the float64 result once reproduces the
    fma bit for bit."""
    recip = float(np.float32(1.0 / (2.0 * qmax)))
    return (s.to(torch.float64) * recip + offset).to(torch.float32)


def w0_column_sums(wq: torch.Tensor, qmax: float = QMAX) -> torch.Tensor:
    """Per output channel, ``sum_k W'[k, n]`` with ``W' = wq/(2*qmax) + 0.5``
    (the MRR transmission domain of paper eq. 6)."""
    k = wq.shape[-2]
    s = wq.to(torch.float32).sum(dim=-2)
    return _affine_fma(s, qmax, 0.5 * k)


def w0_row_sums(wq_t: torch.Tensor, qmax: float = QMAX) -> torch.Tensor:
    """Checksum of the transposed orientation: per output channel of the
    ``wq_t`` image (axis -2), ``sum_n W't[k, n]``."""
    n = wq_t.shape[-1]
    s = wq_t.to(torch.float32).sum(dim=-1)
    return _affine_fma(s, qmax, 0.5 * n)


# =========================================================================
# PreparedTensor
# =========================================================================
@dataclasses.dataclass(frozen=True)
class PreparedTensor:
    """A weight matrix as a programmed photonic bank (int8 + gains).

    ``shape`` reports the logical weight shape, ``astype`` is a no-op, and
    ``x[i]`` slices every field's leading axis (the PRM runner slices the R
    axis this way; slices keep the leaf's tag)."""

    wq: torch.Tensor            # int8 (..., K, N), per-column quantized
    scale: torch.Tensor         # f32  (..., N)
    wq_t: torch.Tensor          # int8 (..., K, N), per-row quantized
    scale_t: torch.Tensor       # f32  (..., K)
    w0_colsum: torch.Tensor     # f32  (..., N)
    w0_rowsum_t: torch.Tensor   # f32  (..., K)
    tag: int = 0

    @property
    def shape(self):
        return tuple(self.wq.shape)

    @property
    def ndim(self):
        return self.wq.ndim

    def astype(self, dtype):
        return self

    def __getitem__(self, idx):
        return PreparedTensor(self.wq[idx], self.scale[idx], self.wq_t[idx],
                              self.scale_t[idx], self.w0_colsum[idx],
                              self.w0_rowsum_t[idx], tag=self.tag)


def prepare_tensor(w: torch.Tensor, qmax: float = QMAX,
                   tag: int = 0) -> PreparedTensor:
    """Program one fp weight (..., K, N) into a PreparedTensor — both
    orientations plus their read-back checksums."""
    wq, scale = quantize_weight(w, qmax)
    wq_t, scale_t = quantize_weight_t(w, qmax)
    return PreparedTensor(wq=wq, scale=scale, wq_t=wq_t, scale_t=scale_t,
                          w0_colsum=w0_column_sums(wq, qmax),
                          w0_rowsum_t=w0_row_sums(wq_t, qmax), tag=tag)


def verify_bank(prep: PreparedTensor, qmax: float = QMAX) -> float:
    """Max |recomputed - stored| checksum error over BOTH orientations
    (~0 for an uncorrupted bank; a corrupted int8 entry shifts a sum by
    >= 1/(2*qmax) ~ 4e-3)."""
    err = (w0_column_sums(prep.wq, qmax) - prep.w0_colsum).abs().max()
    err_t = (w0_row_sums(prep.wq_t, qmax) - prep.w0_rowsum_t).abs().max()
    return float(torch.maximum(err, err_t))


# =========================================================================
# whole-params preparation
# =========================================================================
def path_tag(path) -> int:
    """Stable 31-bit bank identity: crc32 of the JAX ``keystr`` form of the
    parameter path (a tuple of dict keys), e.g.
    ``['segments']['main']['l0']['mixer']['wq']``."""
    return zlib.crc32(keystr(path).encode()) & 0x7FFFFFFF


def _eligible(path, leaf) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if not leaf.is_floating_point():
        return False
    last = next((k for k in reversed(path) if isinstance(k, str)), None)
    return last in MATMUL_LEAVES


def map_with_path(fn, tree, path=()):
    """Apply ``fn(path, leaf)`` to every leaf of a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def flatten_with_path(tree, path=()) -> list:
    """``[(path, leaf), ...]`` of a nested-dict tree in JAX's
    ``tree_flatten_with_path`` order: dict keys sorted at every level (the
    port's ``map_with_path`` keeps insertion order)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_path(tree[k], path + (k,))]
    return [(path, tree)]


def keystr(path) -> str:
    """JAX's ``keystr`` of a dict-key path: ``['segments']['main']...``."""
    return "".join(f"[{k!r}]" for k in path)


def tree_leaves(tree) -> list:
    """Leaves of a nested-dict tree (a PreparedTensor is one leaf)."""
    out: list = []
    map_with_path(lambda _p, leaf: out.append(leaf), tree)
    return out


def prepare_params(params: Any, compute_dtype, photonic: bool) -> Any:
    """Build the prepared bank for a whole model: cast every float32 leaf to
    ``compute_dtype``, then (photonic) program each crossbar matmul weight
    into a :class:`PreparedTensor`.  Cast-then-quantize order as in the
    reference."""
    dtype = torch_dtype(compute_dtype)

    def one(path, leaf):
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32:
            leaf = leaf.to(dtype)
        if photonic and _eligible(path, leaf):
            return prepare_tensor(leaf, tag=path_tag(path))
        return leaf

    return map_with_path(one, params)


MRR_TILE = 128   # physical crossbar tile edge (paper §2: 128x128 MRR array)


def tiles_128(rows: int, cols: int) -> int:
    """128x128 MRR crossbar tiles one (rows, cols) matrix occupies."""
    return -(-rows // MRR_TILE) * -(-cols // MRR_TILE)


def bank_descriptors(bank: Any, prefix: str = "") -> list[dict]:
    """One descriptor per programmed tensor of a prepared bank, in the
    reference's order and with its ``keystr`` paths: path, logical (rows,
    cols) of one matrix slice, the stacked slice count (leading dims), the
    128-tile occupancy and the tag.  ``resident/`` turns these into
    ``BankSpec`` budget entries."""
    out = []
    for path, leaf in flatten_with_path(bank):
        if not isinstance(leaf, PreparedTensor):
            continue
        k, n = int(leaf.wq.shape[-2]), int(leaf.wq.shape[-1])
        stacked = 1
        for d in leaf.wq.shape[:-2]:
            stacked *= int(d)
        out.append({"path": prefix + keystr(path), "rows": k, "cols": n,
                    "stacked": stacked,
                    "mrr_tiles_128": stacked * tiles_128(k, n),
                    "tag": leaf.tag})
    return out


def prepared_stats(bank: Any) -> dict:
    """Bank accounting: programmed tensors, int8 bytes, fp bytes, 128x128
    MRR tiles and W0 checksum words (same keys as the reference)."""
    n_prog = int8_bytes = fp_bytes = mrr_tiles = checksums = 0
    for leaf in tree_leaves(bank):
        if isinstance(leaf, PreparedTensor):
            n_prog += 1
            int8_bytes += leaf.wq.numel() + leaf.wq_t.numel()
            checksums += leaf.w0_colsum.numel() + leaf.w0_rowsum_t.numel()
            k, n = leaf.wq.shape[-2], leaf.wq.shape[-1]
            stacked = 1
            for d in leaf.wq.shape[:-2]:
                stacked *= int(d)
            mrr_tiles += stacked * tiles_128(k, n)
        elif isinstance(leaf, torch.Tensor):
            fp_bytes += leaf.numel() * leaf.element_size()
    return {"programmed_tensors": n_prog, "int8_bytes": int8_bytes,
            "fp_bytes": fp_bytes, "mrr_tiles_128": mrr_tiles,
            "checksum_count": checksums}
