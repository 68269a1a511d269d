"""Photonic fault model — opt-in hardware-honest noise on the MVM path.

Port of ``repro.core.noise``.  The MVM kernels are bit-exact W8A8 (an
ideal crossbar); this module perturbs their RAW output (after the TIA
rescale, before the electronic blend epilogue) with the error sources of a
real Si-MRR array:

  * **per-tile gain error** — a static per-(bank, 128-channel tile) gain
    deviation (fabrication, tuning inaccuracy);
  * **write-age drift** — ``drift_gain_per_nm * expected_drift_nm(age)``
    (``core/aging.py``) times a fixed per-(bank, tile) direction, so drift
    is exactly monotone in age and a reprogram (age -> 0) cancels it;
  * **crosstalk** — neighbouring output channels couple a fraction of each
    other's signal;
  * **DAC/TIA noise** — additive readout noise in output-LSB units
    (``lsb = max|y| / 127``).

``NoiseConfig()`` (all zeros) is disabled and leaves the output untouched.

**Random streams.**  The reference keys every draw on ``jax.random.fold_in``
chains, which torch cannot replay, so the port defines its own generator,
deterministic in (seed, bank tag, orientation, stream, tile):

  * per-tile draws (static gain, drift direction) come from a counter-based
    hash (splitmix64 keyed by the chain, Box-Muller) evaluated on the host
    in float64 and rounded to float32, so the CPU and the card see the same
    numbers.  The gain vector of a (config, bank, orientation) is built once
    and cached on the device; ``Program.update_noise`` drops the cache;
  * the per-element DAC draw is ``torch.randn`` from a ``torch.Generator``
    on the output's device, reseeded from the (seed, bank, orientation,
    ``_STREAM_DAC``) key on every call, so each call of a bank draws the
    same pattern, as in the reference.  The CUDA generator and the CPU one
    give different numbers from one seed: the card's DAC stream differs
    from the CPU's (and both from the reference's).

Hold the port to the reference by value where no draw is involved
(crosstalk) and by property elsewhere (tests/test_torch_noise.py).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import aging as aging_lib

MRR_TILE = 128        # physical tile edge (kept in sync with core/prepared)

# sub-stream tags — one per error source
_STREAM_STATIC = 0    # fabrication gain error (age-independent)
_STREAM_DRIFT = 1     # write-age drift direction (fixed; magnitude ~ age)
_STREAM_DAC = 2       # additive readout noise


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Hashable fault-model description, carried on ``Backend.noise``
    (field for field the reference's).  Installing a new config
    (``Program.update_noise``, e.g. the calibration loop republishing
    ``bank_ages``) drops the device gain cache.

    ``bank_ages`` maps bank tags (``PreparedTensor.tag``) to write ages;
    banks without an entry use the global ``age_writes``.  Stored as a
    sorted tuple of pairs so the config stays hashable.
    """

    gain_sigma: float = 0.0          # static per-tile gain error (rel.)
    crosstalk: float = 0.0           # neighbor-channel coupling fraction
    dac_sigma: float = 0.0           # additive noise, output LSBs
    drift_gain_per_nm: float = 0.05  # gain error per nm of resonance drift
    age_writes: float = 0.0          # default write age (drift source)
    bank_ages: tuple = ()            # ((tag, age_writes), ...) overrides
    writes_per_epoch: float = 1e5    # calibration age-republish granularity
    seed: int = 0
    aging: aging_lib.AgingConfig = aging_lib.AgingConfig()

    def __post_init__(self):
        for f in ("gain_sigma", "crosstalk", "dac_sigma",
                  "drift_gain_per_nm", "age_writes", "writes_per_epoch"):
            if getattr(self, f) < 0:
                raise ValueError(f"NoiseConfig.{f} must be >= 0, got "
                                 f"{getattr(self, f)}")
        for pair in self.bank_ages:
            if len(pair) != 2:
                raise ValueError(f"bank_ages entries must be (tag, age) "
                                 f"pairs, got {pair!r}")

    # ------------------------------------------------------------- queries
    @property
    def enabled(self) -> bool:
        """False for the all-zero default — the bit-identity contract:
        a disabled config never touches the clean kernel output."""
        drift_on = self.drift_gain_per_nm > 0 and (
            self.age_writes > 0 or any(a > 0 for _, a in self.bank_ages))
        return (self.gain_sigma > 0 or self.crosstalk > 0
                or self.dac_sigma > 0 or drift_on)

    def age_for(self, tag) -> float:
        """Write age of bank ``tag`` (None / unknown tag: the global age)."""
        if tag is not None:
            for t, a in self.bank_ages:
                if t == tag:
                    return float(a)
        return float(self.age_writes)

    def drift_sigma(self, age_writes: float) -> float:
        """Gain-error magnitude the accumulated drift at ``age_writes``
        write cycles induces — deterministic and monotone in age (the
        detuning only grows between calibrations)."""
        return self.drift_gain_per_nm * aging_lib.expected_drift_nm(
            max(float(age_writes), 0.0), self.aging)

    def with_bank_ages(self, ages: dict) -> "NoiseConfig":
        """New config with per-bank write ages (the calibration loop's
        republish step).  ``ages`` maps tag -> age_writes; sorted into a
        tuple so the result stays hashable/deterministic."""
        pairs = tuple(sorted((int(t), float(a)) for t, a in ages.items()))
        return dataclasses.replace(self, bank_ages=pairs)

    # --------------------------------------------------------------- parse
    @classmethod
    def parse(cls, spec: str) -> "NoiseConfig":
        """CLI form: ``"gain=0.01,ct=0.002,dac=0.25,drift=0.05,age=1e6"``
        (the reference's ``--noise`` grammar)."""
        alias = {"gain": "gain_sigma", "g": "gain_sigma",
                 "ct": "crosstalk", "xt": "crosstalk",
                 "crosstalk": "crosstalk",
                 "dac": "dac_sigma",
                 "drift": "drift_gain_per_nm",
                 "age": "age_writes",
                 "epoch": "writes_per_epoch",
                 "seed": "seed"}
        kw = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"--noise entries are key=value, got "
                                 f"{item!r}")
            k, v = item.split("=", 1)
            field = alias.get(k.strip())
            if field is None:
                raise ValueError(f"unknown --noise key {k.strip()!r}; have "
                                 f"{sorted(set(alias))}")
            kw[field] = int(v) if field == "seed" else float(v)
        return cls(**kw)


# =========================================================================
# deterministic per-tile draws (host side)
# =========================================================================
_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _mix(z: int) -> int:
    """splitmix64 finalizer on a Python int (64-bit wrap)."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def _mix_arr(z: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer on a uint64 array (numpy wraps on overflow)."""
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@functools.lru_cache(maxsize=None)
def _stream_key(seed: int, tag, transpose: bool, stream: int) -> int:
    """64-bit key of one (seed, bank, orientation, stream): a chain of
    splitmix64 steps, one per word."""
    k = 0
    for word in (seed, (0 if tag is None else int(tag)) & 0x7FFFFFFF,
                 1 if transpose else 0, stream):
        k = _mix(((k ^ (word & _M64)) + _GOLDEN) & _M64)
    return k


@functools.lru_cache(maxsize=None)
def _tile_eps(seed: int, tag, transpose: bool, stream: int,
              n_tiles: int) -> np.ndarray:
    """One standard normal per tile, float32: tile ``i`` reads outputs
    2i+1 and 2i+2 of the splitmix64 stream at the (bank, stream) key —
    counter-based, so a tile's draw never depends on how many tiles the
    bank has — through Box-Muller in float64."""
    key = np.uint64(_stream_key(seed, tag, transpose, stream))
    c = np.arange(1, 2 * n_tiles + 1, dtype=np.uint64)
    h = _mix_arr(key + c * np.uint64(_GOLDEN))
    u = ((h >> np.uint64(11)).astype(np.float64) + 0.5) * 2.0 ** -53
    z = np.sqrt(-2.0 * np.log(u[0::2])) * np.cos(2.0 * math.pi * u[1::2])
    out = z.astype(np.float32)
    out.flags.writeable = False
    return out


def channel_gains(cfg: NoiseConfig, n_channels: int, *, tag=None,
                  transpose: bool = False, age_writes=None,
                  include_static: bool = True,
                  tile: int = MRR_TILE) -> np.ndarray:
    """Per-output-channel multiplicative gain of one bank orientation
    (float32, host): ``1 + gain_sigma*eps_tile + drift_sigma(age)*
    eps_tile_drift``, each eps constant across a 128-wide tile.
    ``age_writes`` overrides the config's age for this bank;
    ``include_static=False`` drops the fabrication term."""
    n_tiles = -(-int(n_channels) // tile)

    def tilewise(stream):
        eps = _tile_eps(cfg.seed, tag, transpose, stream, n_tiles)
        return np.repeat(eps, tile)[:n_channels]

    g = np.ones((n_channels,), np.float32)
    if include_static and cfg.gain_sigma > 0:
        g = g + np.float32(cfg.gain_sigma) * tilewise(_STREAM_STATIC)
    age = cfg.age_for(tag) if age_writes is None else float(age_writes)
    ds = cfg.drift_sigma(age)
    if ds > 0:
        g = g + np.float32(ds) * tilewise(_STREAM_DRIFT)
    return g


# (tag, transpose, n, device) -> (config, device gains or None for ones)
_GAINS: dict = {}


def clear_gain_cache() -> None:
    """Drop every cached device gain vector (a new config was installed)."""
    _GAINS.clear()


def _device_gains(cfg: NoiseConfig, n: int, tag, transpose: bool, device):
    """The config's gain vector of one bank orientation on ``device``,
    built once per (config, bank, orientation): a host-to-device copy per
    matmul would make the host wait for the device.  None when every gain
    is 1 (no multiply needed)."""
    key = (tag, transpose, n, device)
    hit = _GAINS.get(key)
    if hit is not None and hit[0] is cfg:
        return hit[1]
    g = channel_gains(cfg, n, tag=tag, transpose=transpose)
    dev = None if bool((g == 1.0).all()) else torch.from_numpy(g).to(device)
    _GAINS[key] = (cfg, dev)
    return dev


_DAC_GENERATORS: dict = {}


def _dac_normal(cfg: NoiseConfig, shape, tag, transpose: bool, device):
    """Standard normals for the DAC term: the device's generator reseeded
    from the (seed, bank, orientation, DAC) key, so every call of a bank
    draws the same pattern.  On the meta device (the dry-run) there is
    nothing to draw: the shape only."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device=device, dtype=torch.float32)
    gen = _DAC_GENERATORS.get(device)
    if gen is None:
        gen = _DAC_GENERATORS[device] = torch.Generator(device=device)
    gen.manual_seed(_stream_key(cfg.seed, tag, transpose, _STREAM_DAC)
                    & 0x7FFFFFFFFFFFFFFF)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


# =========================================================================
# the perturbation (applied to the raw MVM output)
# =========================================================================
def perturb_mvm_output(y, cfg: NoiseConfig, *, tag=None,
                       transpose: bool = False):
    """Apply the fault model to a raw photonic MVM output ``y`` (..., N) in
    the reference's order: per-tile gain (static + drift, at the config's
    age for bank ``tag``), neighbour crosstalk, then DAC/TIA noise;
    computed in float32 and cast back to y's dtype.  A disabled config
    returns ``y`` itself.  Nothing here waits for the device: the gains are
    cached there and the LSB is a device reduction."""
    if not cfg.enabled:
        return y
    dt = y.dtype
    yf = y.to(torch.float32)
    g = _device_gains(cfg, y.shape[-1], tag, transpose, y.device)
    if g is not None:
        yf = yf * g
    if cfg.crosstalk > 0:
        left = F.pad(yf, (1, 0))[..., :-1]              # channel n-1
        right = F.pad(yf, (0, 1))[..., 1:]              # channel n+1
        yf = yf + cfg.crosstalk * 0.5 * (left + right)
    if cfg.dac_sigma > 0:
        lsb = yf.abs().amax() / 127.0
        yf = yf + cfg.dac_sigma * lsb * _dac_normal(cfg, tuple(yf.shape),
                                                    tag, transpose, y.device)
    return yf.to(dt)


# =========================================================================
# calibration read-back
# =========================================================================
def readback_gain_error(prep, cfg: NoiseConfig, *, age_writes=None) -> float:
    """Re-measure a programmed bank's W0 checksums under its current drift
    and return the worst relative deviation from the stored reference (a
    host float, as in the reference).  The stored checksums were read back
    right after programming, with the static gain folded in, so only the
    drift accumulated since registers; crosstalk and DAC noise are
    invisible to this static read-back."""
    tag = getattr(prep, "tag", None)
    worst = 0.0
    for transpose, ref in ((False, prep.w0_colsum),
                           (True, getattr(prep, "w0_rowsum_t", None))):
        if ref is None:
            continue
        n = int(ref.shape[-1])
        g_now = channel_gains(cfg, n, tag=tag, transpose=transpose,
                              age_writes=age_writes)
        g_prog = channel_gains(cfg, n, tag=tag, transpose=transpose,
                               age_writes=0.0)
        r = ref.detach().to("cpu", torch.float32).numpy()
        measured = r * (g_now / np.maximum(np.abs(g_prog), np.float32(1e-6)))
        rel = np.abs(measured - r) / np.maximum(np.abs(r), np.float32(1e-6))
        worst = max(worst, float(rel.max()))
    return worst
