"""K4's Hopper kernel (``csrc/binned_rqs.cu``): persistent CTAs over a
flat work list of 128-scalar units, each CTA a contiguous chunk of them
with a bulk-copy ring, and the rows' log-determinants in one launch.

CPU tests: what the wrapper (``ops/fused_spline.py``) plans in Python --
the units and their row segments, the CTAs' chunks, the partial indices of
a row that spans chunks, the stage layout and the bulk copies' extents at
any base alignment -- and the C argument struct, unit size and stage
layout against the source; a numpy emulation of the kernel's summation
order (segmented warp scans, the carry across a chunk, per-CTA partials,
the finishing warp's lanes and tree) against the row sums on several
grids; the smoke's records of the kernel and its count of the consumers'
SASS loop.

CUDA tests (marker ``cuda``) hold the kernel against its plain version on
the card, within 1e-4 of max(1, max |plain|) (chip_smoke.py's TOL), one
launch each and bit for bit over two launches, the row counts left at zero:
D = 2 mod 4 with odd rows, D below one unit, B = 70,000 at D = 3, theta and
y as views at 4, 8 and 12 bytes past a 16-byte boundary, bins 1 and 16 on
both branches with and without clamping, points exactly on the knots and
in both tails, and the shipped spline against an f64 run within 2e-5 of
the scale; they skip without one. On the card (no JAX there):
``python -m pytest --noconftest -m cuda tests/test_torch_k4_hopper.py``.
"""

import ctypes
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vit4hep_tpu_torch.ops import fused_spline as fsp
from vit4hep_tpu_torch.ops import rqs

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "vit4hep_tpu_torch" / "csrc" / "binned_rqs.cu"
DOM = (-8.0, 8.0, -8.0, 8.0)
SHIPPED = (10, (0.001, 0.001), DOM, False, None)  # cinn_ds{2,3}_electrons.yaml
TOL = 1e-4
# (b, d): D = 2 mod 4 with odd rows (a row's slice off 16 bytes), D below one
# unit (units span rows), a batch past the old grid's 65,535 rows, D equal to
# the unit, one scalar a row, a row just past a unit
EDGE_SHAPES = [(5, 4002), (9, 7), (70000, 3), (3, 128), (2, 1), (3, 129)]


# ---------------------------------------------------------------------------
# the plan (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,d", EDGE_SHAPES + [(256, 3240), (4, 300), (1, 1)])
def test_units_cover_every_scalar_once(b, d):
    """Every scalar lies in exactly one (unit, row) segment, in order, and
    only a unit's first and last segments can belong to a row that reaches
    past the unit."""
    pl = fsp.plan(b, d, 31)
    assert pl.units == -(-b * d // fsp.UNIT) and pl.partials == pl.units + b
    seen = 0
    for u in range(pl.units):
        segs = fsp.unit_segments(u, pl.n, d)
        for j, (row, lo, hi) in enumerate(segs):
            assert 0 <= lo < hi <= fsp.UNIT and 0 <= row < b
            assert u * fsp.UNIT + lo == seen  # contiguous, in order
            assert (u * fsp.UNIT + lo) // d == row == (u * fsp.UNIT + hi - 1) // d
            seen = u * fsp.UNIT + hi
            if 0 < j < len(segs) - 1:
                assert row * d >= u * fsp.UNIT and (row + 1) * d <= u * fsp.UNIT + fsp.UNIT
    assert seen == b * d


@pytest.mark.parametrize("b,d", EDGE_SHAPES + [(256, 3240), (256, 20250)])
@pytest.mark.parametrize("grid", [1, 7, 132, 396])
def test_chunks_and_partials(b, d, grid):
    """The CTAs' chunks split the units in order, one unit more for the
    first units % grid; ``cta_of`` inverts them; a row's partials, one per
    CTA whose chunk holds some of it, sit at CTA + row, below ``partials``
    and never shared with another row."""
    pl = fsp.plan(b, d, 31)
    grid = min(grid, pl.units)
    starts = [fsp.chunk_start(c, pl.units, grid) for c in range(grid + 1)]
    sizes = np.diff(starts)
    assert starts[0] == 0 and starts[-1] == pl.units and sizes.max() - sizes.min() <= 1
    assert list(sizes) == sorted(sizes, reverse=True)
    for c in range(grid):
        for u in {starts[c], starts[c + 1] - 1}:
            assert fsp.cta_of(u, pl.units, grid) == c
    taken = set()
    rows = range(b) if b * d <= 10 ** 6 else range(0, b, 7)
    for r in rows:
        first, count = fsp.ctas_of_row(r, d, pl.units, grid)
        ctas = {fsp.cta_of(s // fsp.UNIT, pl.units, grid) for s in (r * d, r * d + d - 1)}
        assert min(ctas) == first and max(ctas) == first + count - 1
        for c in range(first, first + count):
            assert c + r not in taken and c + r < pl.partials
            taken.add(c + r)


@pytest.mark.parametrize("p", [4, 31, 49])
def test_stage_holds_every_slice_at_any_alignment(p):
    """A stage is theta's region (UNIT * P floats + a 16-byte lead) then
    y's (UNIT floats + 16): both bulk copies, read from the 16-byte boundary
    at or below the slice and rounded up to 16 bytes, fit their region for
    any base alignment of a float tensor and any unit length."""
    stage = fsp.plan(2, 300, p).stage_bytes
    theta_region, y_region = fsp.UNIT * p * 4 + 16, fsp.UNIT * 4 + 16
    assert stage == theta_region + y_region and stage % 16 == 0 and theta_region % 16 == 0
    assert fsp.UNIT % 4 == 0  # a unit's slices keep their tensor's base alignment
    for base in (0, 4, 8, 12):
        for count in (1, 3, 4, 77, fsp.UNIT):
            for first_unit in range(3):
                for region, per in ((theta_region, p), (y_region, 1)):
                    addr = 4096 + base + first_unit * fsp.UNIT * per * 4
                    src, nbytes, lead = fsp.bulk_copy(addr, count * per * 4)
                    assert src % 16 == 0 and nbytes % 16 == 0 and lead == base
                    assert src <= addr and addr + count * per * 4 <= src + nbytes
                    assert lead + count * per * 4 <= nbytes <= region


def test_args_mirror_the_kernels_struct():
    """``SplineArgs`` has the C struct's fields in its order with its
    types, and the unit size and stage layout are the source's."""
    src = SOURCE.read_text()
    body = re.sub(r"//[^\n]*", "", re.search(r"struct SplineArgs \{(.*?)\};", src, re.S).group(1))
    ctype = {"ptr": ctypes.c_void_p, "long long": ctypes.c_longlong, "int": ctypes.c_int,
             "float": ctypes.c_float}
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"(const )?(unsigned long long|long long|int|float)(\*)?\s+(.*)", decl)
        kind = "ptr" if m.group(3) else m.group(2)
        fields += [(name.strip(), ctype[kind]) for name in m.group(4).split(",")]
    assert [(n, t) for n, t in fsp.SplineArgs._fields_] == fields
    assert int(re.search(r"constexpr int T = (\d+);", src).group(1)) == fsp.UNIT
    assert 2 ** int(re.search(r"constexpr int LOG_T = (\d+);", src).group(1)) == fsp.UNIT
    assert "constexpr int Y_REGION = T * 4 + 16;" in src
    assert "a->stage_bytes != T * a->P * 4 + 16 + Y_REGION" in src


def _kernel_order_logdet(logj, grid):
    """-row sums of ``logj`` (B, D) in the kernel's order on ``grid`` CTAs,
    in float32: in each unit, per warp of 32 scalars a segmented suffix
    scan by row (offsets 1, 2, 4, 8, 16), each row segment adding its warps'
    heads in order; a row's segments in unit order through the CTA's carry
    (carry + segment); a row inside one chunk is done, a row that spans
    chunks is finished from its CTAs' partials by a warp (lane l adds
    partials l, l + 32, ... in order, then a butterfly over offsets 16, 8,
    4, 2, 1)."""
    b, d = logj.shape
    f32 = np.float32
    flat = logj.astype(f32).ravel()
    pl = fsp.plan(b, d, 1)
    grid = min(grid, pl.units)
    partial = {}
    logdet = np.full(b, np.nan, f32)
    lane = np.arange(32)
    for c in range(grid):
        chunk_s0 = fsp.chunk_start(c, pl.units, grid) * fsp.UNIT
        carry, carry_row = f32(0), -1
        for u in range(fsp.chunk_start(c, pl.units, grid), fsp.chunk_start(c + 1, pl.units, grid)):
            s0 = u * fsp.UNIT
            count = min(fsp.UNIT, pl.n - s0)
            vals = np.zeros(fsp.UNIT, f32)
            vals[:count] = flat[s0:s0 + count]
            rows = np.full(fsp.UNIT, -1, np.int64)
            rows[:count] = (s0 + np.arange(count)) // d
            sums = np.empty(fsp.UNIT, f32)
            for w in range(fsp.UNIT // 32):
                v, r = vals[32 * w:32 * w + 32].copy(), rows[32 * w:32 * w + 32]
                for off in (1, 2, 4, 8, 16):
                    take = (lane + off < 32) & (r[np.minimum(lane + off, 31)] == r)
                    v = np.where(take, v + v[np.minimum(lane + off, 31)], v).astype(f32)
                sums[32 * w:32 * w + 32] = v
            segs = fsp.unit_segments(u, pl.n, d)
            for j, (row, lo, hi) in enumerate(segs):
                total = f32(0)
                for w in range(lo >> 5, ((hi - 1) >> 5) + 1):
                    total = f32(total + sums[32 * w + max(lo - 32 * w, 0)])
                if 0 < j < len(segs) - 1:
                    logdet[row] = -total
                    continue
                if j == 0 and carry_row == row:
                    total = f32(carry + total)
                if (row + 1) * d > s0 + count:
                    carry, carry_row = total, row
                elif row * d >= chunk_s0:
                    logdet[row], carry_row = -total, -1
                else:
                    partial[c + row], carry_row = total, -1
        if carry_row >= 0:
            partial[c + carry_row] = carry
    for row in range(b):
        first, count = fsp.ctas_of_row(row, d, pl.units, grid)
        if count == 1:
            continue
        s = np.zeros(32, f32)
        for i in range(count):
            s[i % 32] = f32(s[i % 32] + partial[first + row + i])
        for off in (16, 8, 4, 2, 1):
            s = (s + s[lane ^ off]).astype(f32)
        logdet[row] = -s[0]
    return logdet


@pytest.mark.parametrize("b,d", [(9, 7), (5, 4002), (3, 128), (2, 1), (3, 129), (4, 300),
                                 (2, 5000)])
@pytest.mark.parametrize("grid", [1, 5, 132])
def test_summation_order_gives_the_row_sums(b, d, grid):
    """The kernel's summation order (emulated) adds every log-derivative of
    a row once, on any grid: within f32 rounding of the f64 row sums."""
    logj = np.random.default_rng(b * d).normal(size=(b, d)).astype(np.float32)
    want = -logj.astype(np.float64).sum(1)
    got = _kernel_order_logdet(logj, grid)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.sqrt(d) + 1e-6)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_k4", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_smoke_records_the_kernel():
    """The smoke names the new kernel where it is defined, groups its
    profile rows under K4 (one launch: no second kernel), holds it to the
    unchanged TOL and to f64 within K4_F64_TOL, times the shipped spline."""
    smoke = _chip_smoke()
    source, replaces = smoke.REPLACES["binned_rqs_inverse"]
    path, name = source.split(": ")
    assert f"{name}(SplineArgs a)" in (ROOT / path).read_text()
    assert replaces == "vit4hep_tpu/ops/fused_spline.py:55"
    label, claims = smoke.CINN_GROUPS[0]
    assert label.startswith("K4") and claims(
        "void k4::binned_rqs_inverse_kernel<10, false>(k4::SplineArgs)")
    assert not claims("logdet_reduce_kernel(float const*, float*, int, int)")
    assert smoke.TOL["binned_rqs_inverse"] == 1e-4 and smoke.K4_F64_TOL == 2e-5
    assert smoke.K4_SPLINE == SHIPPED


def test_smoke_counts_the_consumer_loop():
    """``loop_body`` takes the outermost loop around the consumers' named
    barrier from a SASS listing with addresses (a backward branch to its
    start), not the CTA-wide barrier before it, each inner loop once."""
    smoke = _chip_smoke()
    listing = ["MOV R1, c[0x0][0x28] ;", "BAR.SYNC.DEFER_BLOCKING 0x0 ;",
               "SYNCS.PHASECHK.TRANS64 P0, [R2], R3 ;", "@!P0 BRA 0x20 ;", "MUFU.EX2 R4, R5 ;",
               "BAR.SYNC.DEFER_BLOCKING 0x1, 0x80 ;", "FADD R1, R1, R2 ;", "@P1 BRA 0x60 ;",
               "@P2 BRA 0x20 ;", "EXIT ;", "BRA 0xa0;"]
    ins = [(16 * i, line) for i, line in enumerate(listing)]
    assert smoke.loop_body(ins, r"^BAR\.SYNC\S* 0x1,") == listing[2:9]


def test_sass_with_addresses(monkeypatch):
    """``_cuda.sass_functions(..., addresses=True)`` keeps each
    instruction's address, the branch targets ``loop_body`` follows."""
    import types

    from vit4hep_tpu_torch.ops import _cuda

    name = "_ZN2k425binned_rqs_inverse_kernelILi10ELb0ELb0EEEvNS_10SplineArgsE"
    listing = (f"\t\tFunction : {name}\n"
               "        /*0000*/       LDC R1, c[0x0][0x28] ;    /* 0x00000a00ff017b82 */\n"
               "                                                 /* 0x000fe40000000800 */\n"
               "        /*0010*/       @!P0 BRA 0x0 ;            /* 0xfffffffc00fc7947 */\n")
    monkeypatch.setattr(_cuda.subprocess, "run",
                        lambda cmd, **kw: types.SimpleNamespace(stdout=listing))
    funcs = _cuda.sass_functions(Path("libx.so"), addresses=True)
    assert funcs == {name: [(0x0, "LDC R1, c[0x0][0x28]"), (0x10, "@!P0 BRA 0x0")]}


def test_cpu_path_takes_any_batch():
    """On the CPU the wrapper runs the plain version at any batch (the
    kernel's own limit is gone too: the card test at B = 70,000)."""
    rng = np.random.default_rng(0)
    y = torch.from_numpy((rng.normal(size=(70000, 3)) * 6).astype(np.float32))
    theta = torch.from_numpy(rng.normal(size=(70000, 3, 31)).astype(np.float32))
    x, ld = fsp.fused_binned_rqs_inverse(y, theta, *SHIPPED)
    xr, lr = fsp.inverse_plain(y, theta, *SHIPPED)
    assert torch.equal(x, xr) and torch.equal(ld, lr) and x.shape == (70000, 3)


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _inputs(seed, b, d, p, device, y_std=6.0):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy((rng.normal(size=(b, d)) * y_std).astype(np.float32)).to(device)
    theta = torch.from_numpy(rng.normal(size=(b, d, p)).astype(np.float32)).to(device)
    return y, theta


def _holds(y, theta, spline):
    """The kernel against the plain version within TOL of each output's
    scale, two launches bit for bit, one launch each, counts left zero."""
    before = fsp.INVERSE.launches
    x, ld = fsp.fused_binned_rqs_inverse(y, theta, *spline)
    x2, ld2 = fsp.fused_binned_rqs_inverse(y, theta, *spline)
    torch.cuda.synchronize()
    assert fsp.INVERSE.launches == before + 2
    xr, lr = fsp.inverse_plain(y, theta, *spline)
    for out, ref in ((x, xr), (ld, lr)):
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max().item() <= TOL * max(1.0, ref.abs().max().item())
    assert torch.equal(x, x2) and torch.equal(ld, ld2)
    assert not any(sc.rows_done.any() for sc in fsp._SCRATCH.values())
    return x, ld


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", EDGE_SHAPES)
def test_k4_at_uneven_work_lists_on_cuda(cuda_device, b, d):
    y, theta = _inputs(b + d, b, d, 31, cuda_device)
    _holds(y, theta, SHIPPED)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_k4_reads_views_off_16_bytes_on_cuda(cuda_device, offset):
    """theta and y as contiguous views at 4, 8 or 12 bytes past a 16-byte
    boundary, (5, 4002): read in place, not copied."""
    b, d, p = 5, 4002, 31
    y0, t0 = _inputs(offset, b, d, p, cuda_device)
    tbuf = torch.empty(b * d * p + offset, device=cuda_device)
    ybuf = torch.empty(b * d + offset, device=cuda_device)
    theta, y = tbuf[offset:].view(b, d, p), ybuf[offset:].view(b, d)
    theta.copy_(t0)
    y.copy_(y0)
    assert theta.data_ptr() % 16 == 4 * offset and theta.contiguous() is theta
    x, ld = _holds(y, theta, SHIPPED)
    xa, la = fsp.fused_binned_rqs_inverse(y0, t0, *SHIPPED)
    assert torch.equal(x, xa) and torch.equal(ld, la)


@pytest.mark.cuda
@pytest.mark.parametrize("bins", [1, 16])
@pytest.mark.parametrize("identity_tails,clamp", [(True, 15.0), (True, None), (False, 20.0),
                                                  (False, None)])
def test_k4_bins_and_branches_on_cuda(cuda_device, bins, identity_tails, clamp):
    p = rqs.n_params(bins, identity_tails)
    y, theta = _inputs(bins, 7, 1000, p, cuda_device)
    _holds(y, theta, (bins, (0.001, 0.001), DOM, identity_tails, clamp))


def _on_knots(theta, spline):
    """y exactly on the plain version's knots (each interior knot, both
    edges, in turn) and 2.5 past both edges."""
    knots = rqs.binned_constrain(theta, *spline)["knot_y"]
    pick = torch.arange(theta.shape[0] * theta.shape[1], device=theta.device).reshape(
        theta.shape[:2])
    y = torch.gather(knots, -1, (pick % (spline[0] + 1))[..., None])[..., 0]
    y = torch.where(pick % 7 == 3, knots[..., 0] - 2.5, y)
    return torch.where(pick % 7 == 5, knots[..., -1] + 2.5, y).contiguous()


@pytest.mark.cuda
def test_k4_on_knots_and_in_tails_on_cuda(cuda_device):
    """The shipped spline at points exactly on the plain version's knots and
    in both tails: a point at a knot may take the neighbouring bin in the
    kernel (its knots are summed in another order), where the spline is
    C^1, so x and logdet stay within TOL of the plain version."""
    _, theta = _inputs(17, 6, 1500, 31, cuda_device)
    _holds(_on_knots(theta, SHIPPED), theta, SHIPPED)


@pytest.mark.cuda
def test_k4_on_knots_of_narrow_bins_on_cuda(cuda_device):
    """Identity tails with clamping (softmax bins, some ~1e-3 wide) at
    points exactly on the knots: there xi is ill-determined in f32 and the
    log-derivative moves between the bin's two edge slopes, so two f32
    evaluations of the same function differ (the plain version's logdet is
    ~3e-4 of its scale from f64 on these inputs). x stays within TOL of the
    plain version; the logdet is held against an f64 run: no farther from
    it than the f32 plain version, within TOL of the scale; two launches
    agree bit for bit."""
    spline = (10, (0.001, 0.001), DOM, True, 15.0)
    _, theta = _inputs(17, 6, 1500, rqs.n_params(10, True), cuda_device)
    y = _on_knots(theta, spline)
    x, ld = fsp.fused_binned_rqs_inverse(y, theta, *spline)
    x2, ld2 = fsp.fused_binned_rqs_inverse(y, theta, *spline)
    xr, lr = fsp.inverse_plain(y, theta, *spline)
    _, l64 = fsp.inverse_plain(y.double(), theta.double(), *spline)
    assert (x - xr).abs().max().item() <= TOL * max(1.0, xr.abs().max().item())
    scale = max(1.0, l64.abs().max().item())
    assert ((ld.double() - l64).abs().max().item()
            <= (lr.double() - l64).abs().max().item() + TOL * scale)
    assert torch.equal(x, x2) and torch.equal(ld, ld2)


@pytest.mark.cuda
def test_k4_against_f64_on_cuda(cuda_device):
    """The kernel's SFU forms (softplus, logs, reciprocals) against an f64
    run of the plain version: within 2e-5 of each output's scale
    (chip_smoke.py's K4_F64_TOL), as close as the f32 plain version."""
    y, theta = _inputs(64, 16, 3240, 31, cuda_device)
    x, ld = fsp.fused_binned_rqs_inverse(y, theta, *SHIPPED)
    xr, lr = fsp.inverse_plain(y.double(), theta.double(), *SHIPPED)
    for out, ref in ((x, xr), (ld, lr)):
        assert (out.double() - ref).abs().max().item() <= 2e-5 * max(1.0, ref.abs().max().item())
