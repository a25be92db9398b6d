"""Pass 3 — shared-memory, register and grid budgets of the Hopper kernels.

The port's counterpart of ``repro/analysis/pallas_budget.py``.  The TPU
pass traced each ``pallas_call`` and summed VMEM blocks from BlockSpecs.
Here the kernels are CUDA C++ (``kernels/csrc``), and what a launch
asks of the card is decided by each library's host code: its grid, its
block and its dynamic shared memory.  This module mirrors that host
arithmetic in Python, launch for launch, so the CPU can check the budgets
of every kernel instance at every shape, with no card and no ``nvcc``:

* K1 ``kernel_matrix.cu``: a (32, 8) block, no shared memory, query rows
  per thread halved while the grid would not fill the card;
* K2 ``solver.cu``: per-CTA shared memory from ``n_pad``, the slab
  ``chunk`` and the lanes per CTA, which depend on the card's SM count and
  opt-in shared memory (arguments here, the H100's by default);
* K3 ``flash_attention.cu``: f32 ``smem_floats<DH>()``, bf16
  ``TcLayout<DH>::kSmem``;
* K4 ``ssd.cu``: ``state_smem`` / ``scan_smem`` and the state pass;
* K3-bwd ``flash_attention_bwd.cu``: f32, the D pass, then
  ``dkv_smem_floats`` / ``dq_smem_floats``; bf16, the lse / D pre-pass,
  then ``BwdLayout<DH>::kDkvSmem`` / ``kDqSmem``;
* K4-bwd ``ssd_bwd.cu``: ``state_smem`` / ``chunk_smem``, the state pass
  and the group sum.

Each library also exports a plan query that returns the launches its own
host code would make (``csrc/budget.cuh``).  On a card the pass holds the
mirror to it, reads each instance's ``cudaFuncGetAttributes`` and
occupancy, and adds the rules only the card can decide.  A mirror that
disagrees with its library raises: the mirror is then wrong, and no rule
should be read from it.

Rules
-----
``SMEM-BUDGET``      static + dynamic shared memory of a launch above the
                     card's opt-in maximum per block (the static part only
                     on the card).
``GRID-COVERS``      a launch's grid times its tile does not cover the
                     problem, exceeds the card's grid limits, or a shape is
                     not padded upstream (K2's ``n_pad``; K4's ds padded to
                     {8, 16, 32, 64, 128} and ``s % chunk == 0``).
``FUSED-VS-ORACLE``  K2's per-CTA shared memory plus its lanes' global
                     working set is not strictly below the Gram that the
                     oracle stores (lanes x n_pad^2 x 4 B).
``REG-BUDGET``       (card) the registers of one CTA, allocated per warp
                     in units of 256, exceed the SM's.
``REG-SPILL``        (card) ``localSizeBytes > 0``: spills or local arrays;
                     the symbol names the bytes, so a waiver holds one
                     measured frame and a larger one fires again.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import math
from typing import Optional

from repro_torch.analysis.report import Finding

#: The H100 SXM's SM count and opt-in shared memory per block (bytes):
#: the defaults of every card-dependent plan.
H100_SMS = 132
H100_SMEM_OPTIN = 232_448
#: Registers are allocated to a warp in units of this many.
REG_ALLOC_UNIT = 256
WARP = 32
#: CUDA's grid limits (x, y, z).
GRID_LIMITS = (2**31 - 1, 65535, 65535)

CSRC = "src/repro_torch/kernels/csrc"
LIBRARIES = ("kernel_matrix", "solver", "flash_attention", "ssd",
             "flash_attention_bwd", "ssd_bwd")
SOURCE = {lib: f"{CSRC}/{lib}.cu" for lib in LIBRARIES}
#: Ints per launch in a plan query's output, launches per call at most.
PLAN_INTS = 8
MAX_LAUNCHES = 4
ATTR_INTS = 10


@dataclasses.dataclass(frozen=True)
class Launch:
    """One device launch: the kernel instance, grid, block and dynamic
    shared memory (bytes), as the library's host code makes it."""

    kernel: str
    grid: tuple
    block: tuple
    smem: int

    @property
    def threads(self) -> int:
        return math.prod(self.block)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# K1: kernel_matrix.cu plan()
# ---------------------------------------------------------------------------

K1_TX, K1_TY, K1_COLS, K1_MAX_ROWS = 32, 8, 4, 8
K1_FILL_CTAS = 2 * 132
K1_UNROLLED_D = 5
K1_KINDS = {1: "kRbf", 2: "kSech2"}


def k1_rows(n_pairs: int, n: int, m: int) -> int:
    """Query rows per thread: halved while the grid would not fill the
    card."""
    col_tiles = _cdiv(m, K1_TX * K1_COLS)
    rows = K1_MAX_ROWS
    while rows > 1 and col_tiles * n_pairs * _cdiv(n, K1_TY * rows) \
            < K1_FILL_CTAS:
        rows //= 2
    return rows


def k1_plan(n_pairs: int, n: int, m: int, d: int, kind: int) -> list[Launch]:
    """K1's launches for ``x (n, d)`` against ``sv (P, m, d)``; ``kind`` as
    ``kernels.rbf.KINDS`` codes it."""
    if n_pairs <= 0 or n <= 0 or m <= 0:
        return []
    if d <= 0 or kind not in K1_KINDS:
        raise ValueError(f"K1 takes no d = {d}, kind = {kind}")
    rows = k1_rows(n_pairs, n, m)
    dd = d if d <= K1_UNROLLED_D else 0
    return [Launch(f"kernel_matrix_kernel<{K1_KINDS[kind]}, {dd}>",
                   (_cdiv(m, K1_TX * K1_COLS), _cdiv(n, K1_TY * rows),
                    n_pairs), (K1_TX, K1_TY, 1), 0)]


# ---------------------------------------------------------------------------
# K2: solver.cu plan()
# ---------------------------------------------------------------------------

K2_BLOCK, K2_MAX_CHUNK, K2_MAX_LANES, K2_THREADS = 16, 512, 32, 1024
K2_KINDS = {0: "kLinear", 1: "kRbf", 2: "kSech2", 3: "kGram"}
K2_GRAM = 3


def k2_layout(n_pairs: int, n_gamma: int, n_lanes: int, n: int, d: int,
              kind: int, sm_count: int = H100_SMS,
              smem_optin: int = H100_SMEM_OPTIN) -> dict:
    """K2's launch arithmetic: ``n_pad``, ``chunk``, ``fixed_floats``,
    ``lanes_fit``, ``per_cta``, ``groups`` and the launch, on a card with
    ``sm_count`` SMs and ``smem_optin`` bytes per block.  Raises where the
    library refuses the call (not one lane's column fits)."""
    n_pad = _cdiv(n, K2_BLOCK) * K2_BLOCK
    chunk = min(n_pad, K2_MAX_CHUNK)
    tiles = kind != K2_GRAM
    fixed = 2 * K2_BLOCK * (chunk + 4) + n_pad + \
        ((d + 1) * n_pad if tiles else 0)
    lanes_fit = min((smem_optin // 4 - fixed) // n_pad, K2_MAX_LANES)
    if lanes_fit < 1:
        raise ValueError(f"K2 fits no lane of n = {n} in {smem_optin} B")
    cells = n_pairs * n_gamma
    ctas_per_cell = max(1, min(n_lanes, sm_count // cells))
    per_cta = min(_cdiv(n_lanes, ctas_per_cell), lanes_fit)
    groups = _cdiv(n_lanes, per_cta)
    per_cta = _cdiv(n_lanes, groups)
    launch = Launch(f"solver_kernel<{K2_KINDS[kind]}>",
                    (groups, n_gamma, n_pairs), (K2_THREADS, 1, 1),
                    4 * (fixed + per_cta * n_pad))
    return dict(n_pad=n_pad, chunk=chunk, fixed_floats=fixed,
                lanes_fit=lanes_fit, per_cta=per_cta, groups=groups,
                launch=launch)


def k2_plan(n_pairs: int, n_gamma: int, n_lanes: int, n: int, d: int,
            kind: int, sm_count: int = H100_SMS,
            smem_optin: int = H100_SMEM_OPTIN) -> list[Launch]:
    """K2's launches for lanes (P, G, L) over n rows of d features."""
    if n_pairs <= 0 or n_gamma <= 0 or n_lanes <= 0 or n <= 0:
        return []
    if kind not in K2_KINDS or (kind != K2_GRAM and d <= 0):
        raise ValueError(f"K2 takes no kind = {kind}, d = {d}")
    return [k2_layout(n_pairs, n_gamma, n_lanes, n,
                      0 if kind == K2_GRAM else d, kind, sm_count,
                      smem_optin)["launch"]]


# ---------------------------------------------------------------------------
# K3: flash_attention.cu plan_f32 / plan_bf16
# ---------------------------------------------------------------------------

K3_BLOCK_Q, K3_BLOCK_K, K3_THREADS = 64, 64, 256
K3_TC_BLOCK_Q, K3_TC_THREADS, K3_STAGES = 128, 288, 2
K3_HEAD_DIMS = (32, 64, 96, 112, 128)
#: The plan query's first argument: 0 = f32, 1 = bf16, 2 = bf16 storing
#: the row lse (the training forward's instance).
K3_DTYPES = {0: "flash_kernel", 1: "flash_wgmma_kernel",
             2: "flash_wgmma_kernel"}


def k3_smem(dtype: int, dh: int) -> int:
    """Dynamic shared memory of K3 at head dim ``dh``: f32 (0)
    ``smem_floats<DH>()``, bf16 (1) ``TcLayout<DH>::kSmem``."""
    if dtype == 0:
        return 4 * (2 * K3_BLOCK_Q * (dh + 1) + K3_BLOCK_K * dh
                    + K3_BLOCK_Q * (K3_BLOCK_K + 1))
    return 1024 + K3_TC_BLOCK_Q * dh * 2 + K3_STAGES * 2 * K3_BLOCK_K * dh * 2 \
        + 64


def k3_plan(dtype: int, b: int, hq: int, hkv: int, sq: int, skv: int,
            dh: int) -> list[Launch]:
    """K3's launches for q (b, hq, sq, dh) against k, v (b, hkv, skv, dh);
    ``dtype`` 0 = f32, 1 = bf16, 2 = bf16 storing lse."""
    if b <= 0 or hq <= 0 or sq <= 0:
        return []
    if hkv <= 0 or hq % hkv or skv <= 0 or b * hq > 65535 \
            or dtype not in K3_DTYPES or dh not in K3_HEAD_DIMS:
        raise ValueError(f"K3 takes no dtype {dtype}, heads {hq} / {hkv}, "
                         f"dh {dh}")
    name = f"{K3_DTYPES[dtype]}<{dh}{', lse' if dtype == 2 else ''}>"
    if dtype == 0:
        return [Launch(name, (_cdiv(sq, K3_BLOCK_Q), b * hq, 1),
                       (K3_THREADS, 1, 1), k3_smem(0, dh))]
    return [Launch(name, (b * hq, _cdiv(sq, K3_TC_BLOCK_Q), 1),
                   (K3_TC_THREADS, 1, 1), k3_smem(1, dh))]


# ---------------------------------------------------------------------------
# K4: ssd.cu plan<DH, DS>()
# ---------------------------------------------------------------------------

K4_THREADS, K4_MAX_CHUNK, K4_STRIP_LD = 256, 128, 68
K4_DS_WIDTHS = (8, 16, 32, 64, 128)
K4_HEAD_DIMS = (16, 64)


def k4_padded_ds(ds: int) -> int:
    """The state width the kernel is instantiated at for ``ds``."""
    return next(w for w in K4_DS_WIDTHS if ds <= w)


def k4_state_smem(dh: int, ds_pad: int, chunk: int) -> int:
    """Pass 1's dynamic shared memory (``state_smem``)."""
    return 4 * chunk * (dh + ds_pad + 1) + 8 * (K4_MAX_CHUNK // 32)


def k4_scan_smem(dh: int, ds_pad: int, chunk: int) -> int:
    """Pass 3's dynamic shared memory (``scan_smem``): x is staged up to
    ds 64 and read through L1 past it."""
    x_cols = dh if ds_pad <= 64 else 0
    return 4 * (chunk * (x_cols + K4_STRIP_LD + 2 * ds_pad + 2)
                + ds_pad * dh)


def k4_plan(b: int, s: int, nh: int, g: int, dh: int, ds: int, chunk: int,
            chunk_states_only: int = 0) -> list[Launch]:
    """K4's launches for x (b, s, nh, dh), B / C (b, s, g, ds): chunk
    states, state pass, chunk scan (the first alone with
    ``chunk_states_only``)."""
    if b <= 0 or nh <= 0:
        return []
    if g <= 0 or nh % g or not 0 < ds <= K4_DS_WIDTHS[-1] or chunk <= 0 \
            or chunk % 32 or chunk > K4_MAX_CHUNK or s <= 0 or s % chunk \
            or dh not in K4_HEAD_DIMS:
        raise ValueError(f"K4 takes no (s {s}, g {g}, dh {dh}, ds {ds}, "
                         f"chunk {chunk})")
    w = k4_padded_ds(ds)
    tiles = b * (s // chunk) * nh
    blk = (K4_THREADS, 1, 1)
    out = [Launch(f"ssd_chunk_state_kernel<{dh}, {w}>", (tiles, 1, 1), blk,
                  k4_state_smem(dh, w, chunk))]
    if chunk_states_only:
        return out
    return out + [
        Launch("ssd_state_pass_kernel",
               (_cdiv(b * nh * dh * ds, K4_THREADS), 1, 1), blk, 0),
        Launch(f"ssd_chunk_scan_kernel<{dh}, {w}>", (tiles, 1, 1), blk,
               k4_scan_smem(dh, w, chunk))]


# ---------------------------------------------------------------------------
# K4-bwd: ssd_bwd.cu plan<DH, DS>()
# ---------------------------------------------------------------------------

K4B_THREADS, K4B_MAX_CHUNK, K4B_BLOCK, K4B_PAD = 256, 128, 32, 4
K4B_BLOCK_LD = K4B_BLOCK + 1


def k4b_state_smem(dh: int, ds_pad: int, chunk: int) -> int:
    """Pass 1's dynamic shared memory (``state_smem``): dy, C e^{cum}, the
    entering state and e^{cum}."""
    return 4 * (chunk * (dh + K4B_PAD + ds_pad + 1) + dh * (ds_pad + K4B_PAD))


def k4b_chunk_smem(dh: int, ds_pad: int, chunk: int) -> int:
    """Pass 3's dynamic shared memory (``chunk_smem``): dS' and its
    transpose, the x / B / dy / C blocks, the three 32 x 32 blocks, the
    chunk's dC, cum and dcum, and the reductions' scratch."""
    ld_x, ld_b = dh + K4B_PAD, ds_pad + K4B_PAD
    return 8 * (K4B_MAX_CHUNK // 32) + 4 * (
        dh * ld_b + ds_pad * ld_x + 2 * K4B_BLOCK * (ld_x + ld_b)
        + 3 * K4B_BLOCK * K4B_BLOCK_LD + chunk * (ld_b + 2)
        + K4B_THREADS // WARP)


def k4b_plan(b: int, s: int, nh: int, g: int, dh: int, ds: int, chunk: int,
             chunk_states_only: int = 0) -> list[Launch]:
    """K4-bwd's launches for x (b, s, nh, dh), B / C (b, s, g, ds): chunk
    states, state pass, chunk, group sum (the first alone with
    ``chunk_states_only``)."""
    if b <= 0 or nh <= 0:
        return []
    if g <= 0 or nh % g or not 0 < ds <= K4_DS_WIDTHS[-1] or chunk <= 0 \
            or chunk % K4B_BLOCK or chunk > K4B_MAX_CHUNK or s <= 0 \
            or s % chunk or dh not in K4_HEAD_DIMS:
        raise ValueError(f"K4-bwd takes no (s {s}, g {g}, dh {dh}, ds {ds}, "
                         f"chunk {chunk})")
    w = k4_padded_ds(ds)
    tiles = b * (s // chunk) * nh
    blk = (K4B_THREADS, 1, 1)
    out = [Launch(f"ssd_bwd_chunk_state_kernel<{dh}, {w}>", (tiles, 1, 1),
                  blk, k4b_state_smem(dh, w, chunk))]
    if chunk_states_only:
        return out
    return out + [
        Launch("ssd_bwd_state_pass_kernel",
               (_cdiv(b * nh * dh * ds, K4B_THREADS), 1, 1), blk, 0),
        Launch(f"ssd_bwd_chunk_kernel<{dh}, {w}>", (tiles, 1, 1), blk,
               k4b_chunk_smem(dh, w, chunk)),
        Launch("ssd_bwd_group_sum_kernel",
               (_cdiv(b * s * g * ds, K4B_THREADS), 1, 1), blk, 0)]


# ---------------------------------------------------------------------------
# K3-bwd: flash_attention_bwd.cu plan<DH>()
# ---------------------------------------------------------------------------

K3B_BLOCK_Q, K3B_BLOCK_K, K3B_THREADS = 64, 64, 256
K3B_HEAD_DIMS = (32, 64, 96, 112, 128)
#: The bf16 tensor-core kernels: dK / dV CTAs of two consumer warpgroups
#: and a producer warpgroup, dQ CTAs of two and a producer warp; the ring's
#: stages; a q block's lse / D floats.
K3B_TC_CONSUMERS, K3B_DKV_THREADS, K3B_DQ_THREADS = 256, 384, 288
K3B_TC_STAGES, K3B_LD_FLOATS = 2, 128
#: dK / dV CTAs wanted before a bf16 group's q heads are split over grid.z.
K3B_FILL_CTAS = 264


def k3b_per_split(b: int, hkv: int, group: int, skv: int) -> int:
    """q heads per grid.z split of the bf16 dK / dV launch
    (``dkv_per_split``)."""
    ctas = b * hkv * _cdiv(skv, 2 * K3B_BLOCK_K)
    want = 1 if ctas >= K3B_FILL_CTAS else min(group,
                                               _cdiv(K3B_FILL_CTAS, ctas))
    return _cdiv(group, want)


def k3b_smem(dh: int, dtype: int = 0) -> tuple[int, int]:
    """Dynamic shared memory of the dK / dV and the dQ launch at head dim
    ``dh``: f32 (0) ``dkv_smem_floats`` / ``dq_smem_floats``, bf16 (1)
    ``BwdLayout<DH>::kDkvSmem`` / ``kDqSmem``."""
    if dtype == 1:
        tile = K3B_BLOCK_Q * dh * 2
        return (1024 + 4 * tile
                + K3B_TC_STAGES * (2 * tile + 4 * K3B_LD_FLOATS) + 64,
                1024 + 4 * tile + K3B_TC_STAGES * 2 * tile + 64)
    tiles = 4 * K3B_BLOCK_Q * (dh + 1) + 2 * K3B_BLOCK_Q
    ld_p = K3B_BLOCK_K + 1
    return 4 * (tiles + 2 * K3B_BLOCK_K * ld_p), 4 * (tiles + K3B_BLOCK_Q * ld_p)


def k3b_plan(dtype: int, b: int, hq: int, hkv: int, sq: int, skv: int,
             dh: int) -> list[Launch]:
    """K3-bwd's launches for q (b, hq, sq, dh) against k, v (b, hkv, skv,
    dh): D (f32) or the lse / D pre-pass (bf16), dK / dV, dQ, and in bf16
    the splits' sum when the group is split over grid.z; ``dtype`` 0 = f32,
    1 = bf16."""
    if b <= 0 or hq <= 0 or sq <= 0:
        return []
    if hkv <= 0 or hq % hkv or skv <= 0 or b * hq > 65535 \
            or dtype not in (0, 1) or dh not in K3B_HEAD_DIMS:
        raise ValueError(f"K3-bwd takes no dtype {dtype}, heads {hq} / "
                         f"{hkv}, dh {dh}")
    blk = (K3B_THREADS, 1, 1)
    dkv, dq = k3b_smem(dh, dtype)
    rows_per_cta = K3B_THREADS // WARP
    if dtype == 0:
        return [
            Launch("bwd_dot_kernel",
                   (_cdiv(b * hq * sq, rows_per_cta), 1, 1), blk, 0),
            Launch(f"bwd_dkv_kernel<{dh}>",
                   (_cdiv(skv, K3B_BLOCK_K), b * hkv, 1), blk, dkv),
            Launch(f"bwd_dq_kernel<{dh}>",
                   (_cdiv(sq, K3B_BLOCK_Q), b * hq, 1), blk, dq)]
    rows_pad = b * hq * _cdiv(sq, K3B_BLOCK_Q) * K3B_BLOCK_Q
    group = hq // hkv
    splits = _cdiv(group, k3b_per_split(b, hkv, group, skv))
    out = [
        Launch("bwd_prep_kernel", (_cdiv(rows_pad, rows_per_cta), 1, 1), blk,
               0),
        Launch(f"bwd_dkv_wgmma_kernel<{dh}>",
               (b * hkv, _cdiv(skv, 2 * K3B_BLOCK_K), splits),
               (K3B_DKV_THREADS, 1, 1), dkv),
        Launch(f"bwd_dq_wgmma_kernel<{dh}>",
               (b * hq, _cdiv(sq, 2 * K3B_BLOCK_Q), 1),
               (K3B_DQ_THREADS, 1, 1), dq)]
    if splits > 1:
        out.append(Launch("bwd_dkv_sum_kernel",
                          (_cdiv(b * hkv * skv * dh // 2, K3B_THREADS), 1, 1),
                          blk, 0))
    return out


def mirror_plan(library: str, args: tuple, sm_count: int = H100_SMS,
                smem_optin: int = H100_SMEM_OPTIN) -> list[Launch]:
    """The Python mirror of ``library``'s plan for the plan query's
    arguments ``args``."""
    if library == "kernel_matrix":
        return k1_plan(*args)
    if library == "solver":
        return k2_plan(*args, sm_count=sm_count, smem_optin=smem_optin)
    if library == "flash_attention":
        return k3_plan(*args)
    if library == "ssd":
        return k4_plan(*args)
    if library == "flash_attention_bwd":
        return k3b_plan(*args)
    if library == "ssd_bwd":
        return k4b_plan(*args)
    raise ValueError(f"no kernel library {library!r}")


# ---------------------------------------------------------------------------
# The libraries' own answers (card only)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Attributes:
    """``cudaFuncGetAttributes`` of one instance, its CTAs per SM at one
    launch's block and dynamic shared memory, and the card's limits."""

    regs: int
    static_smem: int
    local_bytes: int
    max_threads: int
    ctas_per_sm: int
    regs_per_sm: int
    smem_optin: int
    sm_count: int
    smem_per_sm: int
    const_bytes: int


def _lib(library: str):
    from repro_torch.kernels import build

    return build.library(library), build.c_prefix(library), build


def instance_names(library: str) -> list[str]:
    """The library's kernel instances, in its table's order."""
    lib, prefix, _ = _lib(library)
    name = getattr(lib, f"{prefix}_instance_name")
    return [name(i).decode()
            for i in range(getattr(lib, f"{prefix}_instances")())]


def library_plan(library: str, args: tuple) -> list[Launch]:
    """The launches ``library``'s own host code makes for ``args``."""
    lib, prefix, build = _lib(library)
    out = (ctypes.c_int * (PLAN_INTS * MAX_LAUNCHES))()
    n = ctypes.c_int(0)
    rc = getattr(lib, f"{prefix}_plan")(*[int(a) for a in args], out,
                                        ctypes.byref(n))
    build.check(lib, prefix, rc)
    names = instance_names(library)
    rows = [out[i * PLAN_INTS:(i + 1) * PLAN_INTS] for i in range(n.value)]
    return [Launch(names[r[0]], tuple(r[1:4]), tuple(r[4:7]), r[7])
            for r in rows]


def library_attributes(library: str, launch: Launch) -> Attributes:
    """The card's attributes of ``launch``'s instance at its block and
    dynamic shared memory."""
    lib, prefix, build = _lib(library)
    idx = instance_names(library).index(launch.kernel)
    out = (ctypes.c_int * ATTR_INTS)()
    rc = getattr(lib, f"{prefix}_attributes")(idx, launch.threads,
                                              launch.smem, out)
    build.check(lib, prefix, rc)
    return Attributes(*out)


def card_limits() -> tuple[int, int]:
    """The current card's (SM count, opt-in shared memory per block), as
    K2's host code reads them."""
    lib, prefix, build = _lib("kernel_matrix")
    out = (ctypes.c_int * ATTR_INTS)()
    rc = getattr(lib, f"{prefix}_attributes")(0, K1_TX * K1_TY, 0, out)
    build.check(lib, prefix, rc)
    att = Attributes(*out)
    return att.sm_count, att.smem_optin


@contextlib.contextmanager
def record_launches():
    """Record the plan arguments of every launch of the kernels while
    the context is open: ``{library: set of argument tuples}``.

    Each kernel's launch counter (``kernels.build.LaunchCounter``) collects
    the shapes its wrapper reports at the launch; nothing else changes, and
    the counters stop collecting on exit.  The launches still count."""
    counters = _counters()
    seen = {lib: set() for lib in LIBRARIES}
    for lib, counter in counters.items():
        counter.shapes = seen[lib]
    try:
        yield seen
    finally:
        for counter in counters.values():
            counter.shapes = None


def _counters() -> dict:
    from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                     rbf, solver, ssd, ssd_bwd)

    return {"kernel_matrix": rbf.LAUNCHES, "solver": solver.LAUNCHES,
            "flash_attention": flash_attention.LAUNCHES, "ssd": ssd.LAUNCHES,
            "flash_attention_bwd": flash_attention_bwd.LAUNCHES,
            "ssd_bwd": ssd_bwd.LAUNCHES}


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def _finding(rule: str, library: str, symbol: str, msg: str) -> Finding:
    return Finding(rule=rule, path=SOURCE[library], symbol=symbol,
                   message=msg)


def grid_covers(library: str, args: tuple, launches: list[Launch]
                ) -> list[str]:
    """Why ``launches`` do not cover the call ``args`` (empty if they do)."""
    bad = []
    for ln in launches:
        for axis, (g, lim) in enumerate(zip(ln.grid, GRID_LIMITS)):
            if not 1 <= g <= lim:
                bad.append(f"{ln.kernel}: grid[{axis}] = {g} outside "
                           f"[1, {lim}]")
    if library == "kernel_matrix":
        p, n, m, _, _ = args
        (gx, gy, gz), = [ln.grid for ln in launches]
        if gx * K1_TX * K1_COLS < m or gy * K1_TY * K1_MAX_ROWS < n \
                or gz != p:
            bad.append(f"grid {(gx, gy, gz)} does not cover P {p} x n {n} "
                       f"x m {m}")
    elif library == "solver":
        p, g, l, n, d, kind = args
        ln, = launches
        n_pad = _cdiv(n, K2_BLOCK) * K2_BLOCK
        chunk = min(n_pad, K2_MAX_CHUNK)
        fixed = 2 * K2_BLOCK * (chunk + 4) + n_pad + \
            ((d + 1) * n_pad if kind != K2_GRAM else 0)
        per_cta = (ln.smem // 4 - fixed) // n_pad
        if n_pad % K2_BLOCK or n_pad < n:
            bad.append(f"n_pad {n_pad} is not n {n} padded to {K2_BLOCK}")
        if ln.grid[1:] != (g, p) or ln.grid[0] * per_cta < l \
                or not 1 <= per_cta <= min(K2_MAX_LANES, ln.threads // WARP):
            bad.append(f"grid {ln.grid} x {per_cta} lanes per CTA does not "
                       f"cover (P {p}, G {g}, L {l})")
    elif library == "flash_attention":
        dtype, b, hq, _, sq, _, _ = args
        ln, = launches
        rows, heads = (ln.grid[0] * K3_BLOCK_Q, ln.grid[1]) if dtype == 0 \
            else (ln.grid[1] * K3_TC_BLOCK_Q, ln.grid[0])
        if rows < sq or heads != b * hq:
            bad.append(f"grid {ln.grid} does not cover {b * hq} heads x "
                       f"{sq} query rows")
    elif library == "flash_attention_bwd":
        dtype, b, hq, hkv, sq, skv, dh = args
        pre, dkv, dq, *rest = launches
        rows = b * hq * (sq if dtype == 0
                         else _cdiv(sq, K3B_BLOCK_Q) * K3B_BLOCK_Q)
        if pre.grid[0] * (K3B_THREADS // WARP) < rows:
            bad.append(f"D grid {pre.grid} does not cover {rows} rows")
        if dtype == 0:
            (keys, kv_heads), (q_rows, q_heads) = (
                (dkv.grid[0] * K3B_BLOCK_K, dkv.grid[1]),
                (dq.grid[0] * K3B_BLOCK_Q, dq.grid[1]))
        else:
            (keys, kv_heads), (q_rows, q_heads) = (
                (dkv.grid[1] * 2 * K3B_BLOCK_K, dkv.grid[0]),
                (dq.grid[1] * 2 * K3B_BLOCK_Q, dq.grid[0]))
            splits = dkv.grid[2]
            if splits * k3b_per_split(b, hkv, hq // hkv, skv) < hq // hkv \
                    or bool(rest) != (splits > 1):
                bad.append(f"dK / dV splits {splits} do not cover the "
                           f"{hq // hkv} q heads of a group")
            for ln in rest:
                if ln.grid[0] * K3B_THREADS * 2 < b * hkv * skv * dh:
                    bad.append(f"sum grid {ln.grid} does not cover "
                               f"{b * hkv * skv * dh} values")
        if keys < skv or kv_heads != b * hkv:
            bad.append(f"dK / dV grid {dkv.grid} does not cover {b * hkv} "
                       f"kv heads x {skv} keys")
        if q_rows < sq or q_heads != b * hq:
            bad.append(f"dQ grid {dq.grid} does not cover {b * hq} heads x "
                       f"{sq} query rows")
    elif library in ("ssd", "ssd_bwd"):
        b, s, nh, g, dh, ds, chunk, _ = args
        w = k4_padded_ds(ds)
        if s % chunk:
            bad.append(f"s {s} is not a multiple of chunk {chunk}")
        tiles = b * (s // chunk) * nh
        for ln in launches:
            if ln.kernel in ("ssd_state_pass_kernel",
                             "ssd_bwd_state_pass_kernel"):
                if ln.grid[0] * K4_THREADS < b * nh * dh * ds:
                    bad.append(f"state pass grid {ln.grid} does not cover "
                               f"{b * nh * dh * ds} state values")
                continue
            if ln.kernel == "ssd_bwd_group_sum_kernel":
                if ln.grid[0] * K4B_THREADS < b * s * g * ds:
                    bad.append(f"group sum grid {ln.grid} does not cover "
                               f"{b * s * g * ds} values")
                continue
            if not ln.kernel.endswith(f", {w}>") or w < ds:
                bad.append(f"{ln.kernel}: ds {ds} not padded to {w}")
            if ln.grid[0] != tiles:
                bad.append(f"{ln.kernel}: grid {ln.grid} is not the {tiles} "
                           f"(batch, chunk, head) tiles")
    return bad


def check_launch(library: str, label: str, launch: Launch,
                 smem_budget: int = H100_SMEM_OPTIN,
                 attrs: Optional[Attributes] = None) -> list[Finding]:
    """SMEM-BUDGET, and with the card's ``attrs`` REG-BUDGET and REG-SPILL,
    of one launch; the findings' symbol is the kernel instance, ``label``
    names the call in the message."""
    findings = []
    symbol = launch.kernel
    static = attrs.static_smem if attrs is not None else 0
    if static + launch.smem > smem_budget:
        findings.append(_finding(
            "SMEM-BUDGET", library, symbol,
            f"{label}: {static:,} B static + {launch.smem:,} B "
            f"dynamic shared memory > {smem_budget:,} B per block"))
    if attrs is None:
        return findings
    per_warp = _cdiv(attrs.regs * WARP, REG_ALLOC_UNIT) * REG_ALLOC_UNIT
    regs = _cdiv(launch.threads, WARP) * per_warp
    if regs > attrs.regs_per_sm:
        findings.append(_finding(
            "REG-BUDGET", library, symbol,
            f"{label}: {attrs.regs} registers x {launch.threads} "
            f"threads = {regs:,} per CTA > {attrs.regs_per_sm:,} per SM"))
    if attrs.local_bytes > 0:
        # The bytes are part of the symbol: a waiver covers one measured
        # frame, and a frame that grows is a new finding.
        findings.append(_finding(
            "REG-SPILL", library, f"{symbol} (local {attrs.local_bytes} B)",
            f"{label}: {attrs.local_bytes} B of local memory per "
            f"thread (spills or local arrays)"))
    return findings


def check_call(library: str, symbol: str, args: tuple, *,
               on_card: bool = False, smem_budget: Optional[int] = None,
               sm_count: int = H100_SMS, smem_optin: int = H100_SMEM_OPTIN,
               ) -> tuple[list[Finding], list[dict]]:
    """Every rule over one kernel call's launches -> (findings, one info
    row per launch).  On the card the mirror must equal the library's own
    plan (else AssertionError) and each launch carries its attributes."""
    args = tuple(int(a) for a in args)
    launches = mirror_plan(library, args, sm_count, smem_optin)
    if on_card:
        own = library_plan(library, args)
        if own != launches:
            raise AssertionError(
                f"{library}{args}: the Python mirror plans {launches}, the "
                f"library {own}")
    budget = smem_optin if smem_budget is None else smem_budget
    findings = [_finding("GRID-COVERS", library, symbol, why)
                for why in grid_covers(library, args, launches)]
    rows = []
    for ln in launches:
        attrs = library_attributes(library, ln) if on_card else None
        findings += check_launch(library, symbol, ln, budget, attrs)
        row = dict(library=library, symbol=symbol, args=args,
                   kernel=ln.kernel, grid=ln.grid, block=ln.block,
                   dynamic_smem=ln.smem)
        if attrs is not None:
            row.update(registers=attrs.regs, static_smem=attrs.static_smem,
                       local_bytes=attrs.local_bytes,
                       ctas_per_sm=attrs.ctas_per_sm)
        rows.append(row)
    return findings, rows


# ---------------------------------------------------------------------------
# FUSED-VS-ORACLE
# ---------------------------------------------------------------------------

#: The reference's oracle-comparison configuration
#: (``repro/analysis/pallas_budget.py`` SOLVER_CONFIG): 2 pairs x 3 gammas
#: x 6 C / fold lanes over n = 256, d = 4.
SOLVER_CONFIG = dict(p=2, g=3, l=6, n=256, d=4)
#: The har12 fit's rbf CV grid: 66 pairs x 7 gammas x 35 lanes, n 1582.
HAR12_RBF_GRID = dict(p=66, g=7, l=35, n=1582, d=5)


def fused_vs_oracle(cfg: dict, oracle_bytes: Optional[int] = None,
                    sm_count: int = H100_SMS,
                    smem_optin: int = H100_SMEM_OPTIN,
                    ) -> tuple[dict, list[Finding]]:
    """K2's memory contract at ``cfg``: one CTA's shared memory plus every
    lane's global working set (its C-box row read, its alpha and margins
    written: 3 x n_pad f32) and the pairs' inputs (x, y) must stay strictly
    below the (lanes, n_pad, n_pad) f32 Gram the oracle stores.
    ``oracle_bytes`` overrides the oracle, so a test can seed a
    regression."""
    p, g, l, n, d = (cfg[k] for k in ("p", "g", "l", "n", "d"))
    lay = k2_layout(p, g, l, n, d, 1, sm_count, smem_optin)
    n_pad = lay["n_pad"]
    lanes = p * g * l
    if oracle_bytes is None:
        oracle_bytes = lanes * n_pad * n_pad * 4
    per_lane = 3 * n_pad * 4
    fused = lay["launch"].smem + lanes * per_lane + p * n_pad * (d + 1) * 4
    findings = []
    if not fused < oracle_bytes:
        findings.append(_finding(
            "FUSED-VS-ORACLE", "solver", "solver_kernel",
            f"at {cfg}: {fused:,} B (one CTA's shared memory + the lanes' "
            f"global working set) is not strictly below the oracle's "
            f"stored Gram {oracle_bytes:,} B ({lanes} lanes x {n_pad}^2 x "
            f"f32)"))
    info = dict(config=cfg, lanes=lanes, n_pad=n_pad,
                cta_smem_bytes=lay["launch"].smem,
                lane_global_bytes=per_lane, fused_bytes=fused,
                oracle_gram_bytes=oracle_bytes,
                ratio=fused / oracle_bytes if oracle_bytes else None,
                holds=bool(fused < oracle_bytes))
    return info, findings


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------

#: The kernel calls the main paths make, at their shapes (the plan query's
#: arguments): the deployed banks and the padded training set (K1), the
#: Table II and har12 CV lanes in every mode (K2), each served prefill's
#: attention in both dtypes (K3), hymba's and mamba2's scans (K4), the
#: training attention forward and backward (K3, K3-bwd) of granite-moe,
#: K3-bwd at every large-head-dim config's training microbatch, and the
#: scan and its gradient (K4, K4-bwd) at hymba's and mamba2's.
MAIN_PATH_CALLS = (
    ("kernel_matrix", "balance rbf bank", (3, 188, 71, 4, 1)),
    ("kernel_matrix", "har12 rbf bank", (66, 1875, 675, 5, 1)),
    ("kernel_matrix", "har12 width rbf", (4, 1875, 1582, 5, 1)),
    ("kernel_matrix", "har12 width sech2", (4, 1875, 1582, 5, 2)),
    ("solver", "balance linear CV", (3, 1, 35, 399, 4, 0)),
    ("solver", "balance rbf CV", (3, 7, 35, 399, 4, 1)),
    ("solver", "balance sech2 CV", (3, 7, 35, 399, 4, 2)),
    ("solver", "balance hw CV (Gram)", (3, 7, 35, 399, 0, 3)),
    ("solver", "reference SOLVER_CONFIG", (2, 3, 6, 256, 4, 1)),
    ("solver", "har12 rbf CV", (66, 7, 35, 1582, 5, 1)),
    ("solver", "har12 hw CV, one gamma (Gram)", (66, 1, 35, 1582, 0, 3)),
    ("solver", "har12 rbf refit", (66, 1, 1, 1582, 5, 1)),
    ("flash_attention", "hymba bf16", (1, 4, 25, 5, 2048, 2048, 64)),
    ("flash_attention", "hymba f32", (0, 4, 25, 5, 2048, 2048, 64)),
    ("flash_attention", "phi-3-vision bf16", (1, 4, 32, 32, 2624, 2624, 96)),
    ("flash_attention", "kimi-k2 bf16", (1, 4, 64, 8, 2048, 2048, 112)),
    ("flash_attention", "starcoder2 bf16", (1, 4, 36, 4, 2048, 2048, 128)),
    ("flash_attention", "starcoder2 f32", (0, 4, 36, 4, 2048, 2048, 128)),
    ("flash_attention", "whisper cross bf16", (1, 4, 16, 16, 64, 1500, 64)),
    ("ssd", "hymba", (4, 2048, 50, 1, 64, 16, 128, 0)),
    ("ssd", "mamba2", (4, 2048, 80, 1, 64, 128, 128, 0)),
    ("ssd", "hymba training", (2, 4096, 50, 1, 64, 16, 128, 0)),
    ("ssd", "mamba2 training", (2, 4096, 80, 1, 64, 128, 128, 0)),
    ("ssd_bwd", "hymba training", (2, 4096, 50, 1, 64, 16, 128, 0)),
    ("ssd_bwd", "mamba2 training", (2, 4096, 80, 1, 64, 128, 128, 0)),
    ("flash_attention", "granite-moe training bf16 (lse)",
     (2, 2, 16, 8, 4096, 4096, 64)),
    ("flash_attention_bwd", "granite-moe training bf16",
     (1, 2, 16, 8, 4096, 4096, 64)),
    ("flash_attention_bwd", "granite-moe training f32",
     (0, 2, 16, 8, 4096, 4096, 64)),
    ("flash_attention_bwd", "whisper encoder bf16",
     (1, 2, 16, 16, 1500, 1500, 64)),
    ("flash_attention", "phi-3-vision training bf16 (lse)",
     (2, 2, 32, 32, 4096, 4096, 96)),
    ("flash_attention_bwd", "phi-3-vision training bf16",
     (1, 2, 32, 32, 4096, 4096, 96)),
    ("flash_attention_bwd", "kimi-k2 training bf16",
     (1, 1, 64, 8, 4096, 4096, 112)),
    ("flash_attention_bwd", "starcoder2 training bf16",
     (1, 2, 36, 4, 4096, 4096, 128)),
    ("flash_attention_bwd", "command-r training bf16",
     (1, 1, 64, 8, 4096, 4096, 128)),
    ("flash_attention_bwd", "qwen2.5-32b training bf16",
     (1, 2, 40, 8, 4096, 4096, 128)),
    ("flash_attention_bwd", "granite-20b training bf16 (MQA)",
     (1, 2, 48, 1, 4096, 4096, 128)),
)


def check_calls(calls, *, on_card: bool = False,
                smem_budget: Optional[int] = None,
                oracle_bytes: Optional[int] = None,
                ) -> tuple[list[Finding], dict]:
    """Pass 3 over ``calls`` (``(library, label, args)``): every launch's
    budgets and coverage, and K2's contract at the reference's
    configuration and the har12 grid.  On the card the SM count and opt-in
    shared memory are the card's, and each launch carries its attributes."""
    sm_count, smem_optin = card_limits() if on_card \
        else (H100_SMS, H100_SMEM_OPTIN)
    findings: list[Finding] = []
    rows = []
    for library, label, args in calls:
        symbol = f"{library}[{label}]"
        fnds, r = check_call(library, symbol, args, on_card=on_card,
                             smem_budget=smem_budget, sm_count=sm_count,
                             smem_optin=smem_optin)
        findings += fnds
        rows += r
    contracts = []
    for cfg in (SOLVER_CONFIG, HAR12_RBF_GRID):
        info, fnds = fused_vs_oracle(cfg, oracle_bytes, sm_count, smem_optin)
        contracts.append(info)
        findings += fnds
    info = dict(sm_count=sm_count, smem_optin=smem_optin,
                smem_budget=smem_optin if smem_budget is None
                else smem_budget, launches=rows, fused_vs_oracle=contracts)
    return findings, info


def check_kernels(smem_budget: Optional[int] = None,
                  oracle_bytes: Optional[int] = None,
                  on_card: bool = False) -> tuple[list[Finding], dict]:
    """The full Pass 3 at the main paths' shapes (``MAIN_PATH_CALLS``)."""
    return check_calls(MAIN_PATH_CALLS, on_card=on_card,
                       smem_budget=smem_budget, oracle_bytes=oracle_bytes)
