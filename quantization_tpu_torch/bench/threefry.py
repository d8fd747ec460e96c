"""JAX's threefry PRNG in PyTorch, and the 10M harness's row generator on it.

``jax.random`` with ``jax_threefry_partitionable`` (the default of the JAX
the reference runs on) draws every value from one Threefry-2x32 hash of a
key and a counter, so the JAX harness's corpus (``tools/bench_10m.py``,
each row drawn from ``fold_in(key(42), row_id)``) can be made here from row
ids alone, to the bit where the draws are integers:

  * ``fold_in(key, d)`` hashes the counter (0, d);
  * ``split(key, num)`` hashes (0, i) for i < num (the fold-like split);
  * ``random_bits(key, shape)`` hashes (0, j) for each flat position j and
    returns the xor of the two output words;
  * ``uniform`` puts the top 23 bits in a float's mantissa, ``normal`` maps
    a uniform draw on [nextafter(-1, 0), 1) through XLA's f32 ``ErfInv``
    polynomial (its Horner steps as fused multiply-adds, as JAX's compiled
    code runs them), ``randint`` is JAX's ``_randint`` (two draws, the
    span/multiplier remainder).

Normals agree with ``jax.random.normal`` within 4.8e-7 (XLA's and torch's
``log1p`` differ in the last bit; 99 % of values are equal). The plain
versions compute on int64 tensors masked to 32 bits, so they run alike on
the CPU and the card.

``latent_rows`` writes whole corpus rows from their ids: the per-row key,
its subkeys, the cluster draw, D normals and, for the ``realistic``
distribution, the radial draw. On a CUDA tensor it launches the
hand-written ``qtt_rowgen`` kernel (``csrc/rowgen_kernels.cu``), on a CPU
tensor it takes ``latent_rows_plain``. The kernel replaces no TPU kernel:
the JAX harness left the draw to XLA. It exists because the harness makes
its 10M-row corpus about 14 times over, and as torch ops on int64 a pass
costs seconds where the kernel, bound by its integer operations, costs
tens of milliseconds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dispatch import use_kernels
from ..ops.kernels.build import check, load_library
from ..ops.kernels.ktile import check_tensors

MASK = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# jax.random.normal draws uniform on [NORMAL_LO, 1) and returns
# sqrt(2) * erfinv(u) (jax/_src/random.py _normal_real).
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2.0)))
# XLA's f32 ErfInv (its math library's ErfInv32): Giles' polynomials in
# w = -log1p(-x^2) - 2.5 (w < 5) or sqrt(w) - 3.
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GT5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# Rows per block of the plain row generator (bounds its int64 temporaries).
PLAIN_ROWS = 4096

#: Kernel launches since the last reset (plain runs not counted).
LAUNCHES = {"latent_rows": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _u32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter (x0, x1) under the key
    (k0, k1): int64 tensors holding uint32 values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int, device=None):
    """``jax.random.key(seed)``'s data for a seed below 2^32: (0, seed)."""
    return _u32(0, device), _u32(seed, device)


def fold_in(k, data):
    """``jax.random.fold_in``: the key hashed with the counter (0, data);
    ``data`` may be a tensor of ids (one key each)."""
    k0, k1 = k
    return threefry2x32(k0, k1, torch.zeros_like(k0), _u32(data, k0.device))


def split(k, num: int = 2):
    """``jax.random.split`` (partitionable): the list of ``num`` keys
    hashed from the counters (0, i)."""
    k0, k1 = k
    zero = torch.zeros_like(k0)
    return [threefry2x32(k0, k1, zero, zero + i) for i in range(num)]


def random_bits(k, shape=()):
    """``jax.random.bits`` (uint32) as int64: shape ``k``'s shape +
    ``shape``, each the xor of the hash of (0, flat position)."""
    k0, k1 = k
    size = int(np.prod(shape, dtype=np.int64))
    counts = torch.arange(size, dtype=torch.int64, device=k0.device).reshape(shape)
    ex = (...,) + (None,) * len(shape)
    y0, y1 = threefry2x32(k0[ex], k1[ex], torch.zeros_like(counts), counts)
    return y0 ^ y1


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform`` of given bits: the top 23 bits as a mantissa
    in [1, 2), less one, scaled to [minval, maxval) in f32."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    span = float(np.float32(maxval) - np.float32(minval))
    lo = float(np.float32(minval))
    return torch.clamp(f * span + lo, min=lo)


def uniform(k, shape=(), minval: float = 0.0, maxval: float = 1.0):
    return uniform_from_bits(random_bits(k, shape), minval, maxval)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ErfInv, each Horner step one fused multiply-add (an f64
    product and sum rounded once to f32)."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    lt5 = torch.tensor(ERFINV_LT5, dtype=torch.float32, device=x.device)
    gt5 = torch.tensor(ERFINV_GT5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lt5[0], gt5[0])
    for i in range(1, len(ERFINV_LT5)):
        p = (p.double() * w + torch.where(lt, lt5[i], gt5[i]).double()).float()
    return p * x


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    return erfinv_xla(uniform_from_bits(bits, NORMAL_LO, 1.0)) * SQRT2


def normal(k, shape=()):
    """``jax.random.normal`` (f32)."""
    return normal_from_bits(random_bits(k, shape))


def randint(k, minval: int, maxval: int, shape=()):
    """``jax.random.randint`` (int32 range) as int64: JAX's ``_randint``,
    two 32-bit draws folded into the span by the 2^32 mod span
    multiplier."""
    ka, kb = split(k, 2)
    hi, lo = random_bits(ka, shape), random_bits(kb, shape)
    span = max(int(maxval) - int(minval), 1)
    mult = (((2**16 % span) ** 2) & MASK) % span  # uint32 products wrap
    off = (((hi % span) * mult) & MASK) + lo % span
    return int(minval) + (off & MASK) % span


# --------------------------------------------------------------- the rows
def _row_draws(ids, base, clusters, realistic):
    """(noise key, cluster, radial or None) per row of ``ids``: the per-row
    key fold_in(base, id) split in 3 (realistic: cluster, noise, radial)
    or 2 (clustered: cluster, noise)."""
    subkeys = split(fold_in(base, ids), 3 if realistic else 2)
    assign = randint(subkeys[0], 0, clusters)
    radial = torch.exp(0.25 * normal(subkeys[2])) if realistic else None
    return subkeys[1], assign, radial


def latent_rows_plain(ids, centers, spectrum, sigma: float, base, return_clusters=False):
    """Plain version of the row kernel: f32 [len(ids), D] rows before the
    rotation and the normalisation. ``spectrum`` None is the clustered
    distribution, centers[c] + sigma * normal(D); else the realistic one,
    (centers[c] + sigma * normal(D) * spectrum) * exp(0.25 * normal).
    ``return_clusters`` also returns each row's cluster c (int32)."""
    ids = ids.to(device=centers.device, dtype=torch.int64)
    n, d = ids.shape[0], centers.shape[1]
    base = tuple(_u32(b, centers.device) for b in base)
    out = torch.empty((n, d), dtype=torch.float32, device=centers.device)
    clusters = torch.empty((n,), dtype=torch.int32, device=centers.device)
    for r0 in range(0, n, PLAIN_ROWS):
        nk, assign, radial = _row_draws(ids[r0 : r0 + PLAIN_ROWS], base, centers.shape[0],
                                        spectrum is not None)
        clusters[r0 : r0 + PLAIN_ROWS] = assign
        noise = normal(nk, (d,)) * sigma
        if spectrum is None:
            out[r0 : r0 + PLAIN_ROWS] = centers[assign] + noise
        else:
            out[r0 : r0 + PLAIN_ROWS] = (centers[assign] + noise * spectrum) * radial[:, None]
    return (out, clusters) if return_clusters else out


def latent_rows(ids, centers, spectrum, sigma: float, base, return_clusters=False):
    """The rows of ``ids`` (``latent_rows_plain``'s function): the kernel
    for CUDA ``centers``, the plain version for CPU ones. Both take an id's
    low 32 bits, the JAX harness's int32 id of the same bits; the ids are
    not checked here, as reading them would wait for the card
    (``RowSource`` keeps its ids below 2^31)."""
    if not use_kernels(centers):
        return latent_rows_plain(ids, centers, spectrum, sigma, base, return_clusters)
    n = ids.shape[0]
    nc, d = centers.shape
    ids32 = ids.to(device=centers.device, dtype=torch.int32).contiguous()
    check_tensors(centers.device, (("centers", centers, torch.float32, (nc, d)),))
    if spectrum is not None:
        check_tensors(centers.device, (("spectrum", spectrum, torch.float32, (d,)),))
    out = torch.empty((n, d), dtype=torch.float32, device=centers.device)
    clusters = (torch.empty((n,), dtype=torch.int32, device=centers.device)
                if return_clusters else None)
    if n == 0:
        return (out, clusters) if return_clusters else out
    k0, k1 = (int(b) & MASK for b in base)
    lib = load_library()
    err = lib.qtt_rowgen(
        ids32.data_ptr(), n, d, centers.data_ptr(), nc,
        None if spectrum is None else spectrum.data_ptr(), float(sigma), k0, k1,
        out.data_ptr(), None if clusters is None else clusters.data_ptr(),
        torch.cuda.current_stream(centers.device).cuda_stream,
    )
    check(lib, err, "latent_rows")
    LAUNCHES["latent_rows"] += 1
    return (out, clusters) if return_clusters else out
