"""Port: letterbox geometry, the plain letterbox (the kernel's CPU version)
against the JAX preprocess and the Pallas kernel, box unscaling, and the
kernel wrapper's argument checks."""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aicamera_tpu.ops import preprocess as jprep  # noqa: E402
from aicamera_tpu_torch.ops import letterbox as tlb  # noqa: E402
from aicamera_tpu_torch.ops import preprocess as tprep  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    PyTorch's thread pool oversubscribes the cores (small convolutions then
    run ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The kernel phase's geometries: (src_hw, dst_hw, auto).
GEOMETRIES = [
    ((540, 960), (640, 640), False),
    ((720, 1280), (640, 640), False),
    ((1080, 1920), (640, 640), False),
    ((640, 640), (640, 640), False),    # identity: no resize, no rounding
    ((240, 320), (640, 640), False),    # pad only: no scale-up
    ((540, 960), (640, 640), True),     # auto canvas 384x640
]


def _frame(hw, seed):
    return np.random.RandomState(seed).randint(0, 256, (*hw, 3), np.uint8)


@pytest.mark.parametrize("src", [(540, 960), (720, 1280), (1080, 1920),
                                 (101, 640), (100, 200), (640, 640),
                                 (480, 640), (1000, 333), (37, 1999)])
@pytest.mark.parametrize("mode", ["square", "auto", "scale_fill", "scaleup"])
def test_letterbox_spec_matches_jax(src, mode):
    kw = {"auto": mode == "auto", "scale_fill": mode == "scale_fill",
          "scaleup": mode == "scaleup"}
    for dst in ((640, 640), (384, 640), (128, 128)):
        a = jprep.letterbox_spec(src, dst, **kw)
        b = tprep.letterbox_spec(src, dst, **kw)
        assert dataclass_tuple(a) == dataclass_tuple(b)
        assert (a.bottom, a.right) == (b.bottom, b.right)


def dataclass_tuple(s):
    return (s.src_hw, s.dst_hw, s.ratio, s.unpad_hw, s.pad_wh, s.top,
            s.left, s.out_hw)


@pytest.mark.parametrize("dst,src", [(360, 540), (640, 960), (360, 1080),
                                     (640, 1920), (7, 3), (3, 7), (5, 5),
                                     (128, 54), (1, 9)])
def test_resize_taps_equal_the_dense_jax_weights(dst, src):
    """The taps rebuild the JAX dense bilinear matrix bit for bit
    (tolerance: bitwise), including clamped and exact-integer coordinates."""
    i0, i1, w0, w1 = tprep.resize_taps(dst, src)
    dense = np.zeros((dst, src), np.float32)
    rows = np.arange(dst)
    dense[rows, i0] += w0
    dense[rows, i1] += w1
    np.testing.assert_array_equal(dense, jprep._resize_weights(dst, src))
    assert ((w1 == 0) | (i1 == i0 + 1)).all()


@pytest.mark.parametrize("src,dst,auto", GEOMETRIES)
def test_plain_letterbox_matches_jax_preprocess(src, dst, auto):
    """Tolerance: one uint8 step (1/255). The JAX version sums a dense
    matrix product (its CPU dot may fuse multiply-adds); the plain version
    rounds each product and sum, so a value at .5 can round the other way."""
    frame = _frame(src, seed=src[0])
    js = jprep.letterbox_spec(src, dst, auto=auto)
    ts = tprep.letterbox_spec(src, dst, auto=auto)
    ref = np.asarray(jax.jit(lambda f: jprep.preprocess_yolo(
        f, js, jnp.float32))(jnp.asarray(frame)))
    ours = tprep.preprocess_yolo(torch.from_numpy(frame), ts).numpy()
    assert ours.shape == ref.shape == (1, *ts.out_hw, 3)
    diff = np.abs(ours - ref)
    print(f"{src}->{ts.out_hw}: max |diff| {diff.max() * 255:.3f}/255, "
          f"share off by >= one grey level {np.mean(diff > 0.5 / 255):.2e}, "
          f"share off by an ulp or more {np.mean(diff > 0):.2e}")
    assert diff.max() <= 1.0 / 255.0 + 1e-7
    if ts.unpad_hw == ts.src_hw:
        # identity: same pixels; XLA turns the division by 255 into a
        # multiplication by its reciprocal, one f32 ulp away at most
        np.testing.assert_allclose(ours, ref, rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("src,dst", [((54, 96), (64, 64)),
                                     ((16, 128), (192, 128)),
                                     ((270, 480), (320, 320))])
def test_plain_letterbox_matches_pallas_kernel(src, dst):
    """Against the TPU kernel in interpret mode. Tolerance: one uint8 step,
    the bound the Pallas kernel itself meets against the XLA version."""
    from aicamera_tpu.ops.pallas_preprocess import preprocess_yolo_pallas
    from jax.experimental.pallas import tpu as pltpu
    frame = _frame(src, seed=7)
    js = jprep.letterbox_spec(src, dst)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(preprocess_yolo_pallas(jnp.asarray(frame), js,
                                                jnp.float32))
    ours = tprep.preprocess_yolo(torch.from_numpy(frame),
                                 tprep.letterbox_spec(src, dst)).numpy()
    assert np.abs(ours - ref).max() <= 1.0 / 255.0 + 1e-7


def test_letterbox_batches_and_bf16():
    """(K, H, W, 3) -> (K, 3, Dh, Dw): each frame equals its own
    preprocess_yolo (tolerance: bitwise); bf16 is the f32 result rounded."""
    frames = np.stack([_frame((54, 96), s) for s in range(3)])
    spec = tprep.letterbox_spec((54, 96), (64, 64))
    out = tlb.letterbox(torch.from_numpy(frames), spec)
    assert out.shape == (3, 3, 64, 64) and out.dtype == torch.float32
    for i in range(3):
        single = tprep.preprocess_yolo(torch.from_numpy(frames[i]), spec)
        assert torch.equal(out[i], single[0].permute(2, 0, 1))
    bf = tlb.letterbox(torch.from_numpy(frames), spec, torch.bfloat16)
    assert torch.equal(bf, out.to(torch.bfloat16))
    # pad rows are exactly 114/255 in f32
    assert torch.all(out[:, :, :spec.top] == torch.tensor(114.0) / 255.0)


def test_scale_boxes_back_matches_jax():
    rng = np.random.RandomState(3)
    boxes = rng.uniform(-50, 700, (5, 40, 4)).astype(np.float32)
    for src, dst, auto in GEOMETRIES:
        js = jprep.letterbox_spec(src, dst, auto=auto)
        ts = tprep.letterbox_spec(src, dst, auto=auto)
        ref = np.asarray(jprep.scale_boxes_back(jnp.asarray(boxes), js))
        ours = tprep.scale_boxes_back(torch.from_numpy(boxes), ts).numpy()
        np.testing.assert_array_equal(ours, ref)  # tolerance: bitwise


# The geometries of test_letterbox_spec_matches_jax, to (640, 640) and to the
# narrow (128, 96) canvas.
PLAN_SOURCES = [(540, 960), (720, 1280), (1080, 1920), (101, 640),
                (100, 200), (640, 640), (480, 640), (1000, 333), (37, 1999)]


@pytest.mark.parametrize("src", PLAN_SOURCES)
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_launch_plan_picks_variant_and_covers_rows(src, k, dtype):
    """Aligned shapes get the vector variant, misaligned ones the scalar
    one; the band fits shared memory; the grid covers every output row (the
    scalar grid: every output pixel) exactly once."""
    for dst in ((640, 640), (128, 96)):
        spec = tprep.letterbox_spec(src, dst)
        dh, dw = spec.out_hw
        plan = tlb.launch_plan(spec, k, dtype)
        aligned = (src[1] * 3) % 16 == 0 and dw % 8 == 0
        assert plan.variant == ("vector" if aligned else "scalar"), plan
        if not aligned:
            assert plan.reason and plan.smem_bytes == 0
            threads = plan.grid[0] * plan.block[0]
            assert k * dh * dw <= threads < k * dh * dw + plan.block[0]
            continue
        assert 0 < plan.smem_bytes <= tlb.SMEM_LIMIT
        assert plan.smem_bytes == tlb.band_rows(spec, plan.rows) * src[1] * 3
        assert plan.smem_bytes % 16 == 0
        tiles, frames = plan.grid
        assert frames == k
        covered = np.zeros(dh, int)
        for t in range(tiles):
            covered[t * plan.rows:min((t + 1) * plan.rows, dh)] += 1
        assert (covered == 1).all()
        groups, block_rows = plan.block
        assert groups * tlb.GROUP == dw
        assert 1 <= block_rows <= plan.rows
        assert groups * block_rows <= tlb.MAX_GROUPS
        # the same call on a pointer off the 16-byte grid: scalar
        off = tlb.launch_plan(spec, k, dtype, frames_aligned=False)
        assert off.variant == "scalar" and "16-byte" in off.reason


def test_launch_plan_limits(monkeypatch):
    """A source row beyond the 16-bit tap offsets, a band beyond shared
    memory, an output row beyond the block, or more frames than the grid
    holds take the scalar variant, with the reason named; a forced variant
    is honoured or refused."""
    wide = tprep.letterbox_spec((4096, 131072), (640, 640))
    plan = tlb.launch_plan(wide, 1, torch.float32)
    assert plan.variant == "scalar" and "16-bit" in plan.reason
    full_hd = tprep.letterbox_spec((1080, 1920), (640, 640))
    # the widest rows the tap offsets allow, two to a band, still fit
    assert 2 * 65535 <= tlb.SMEM_LIMIT == 227 * 1024
    with monkeypatch.context() as m:
        m.setattr(tlb, "SMEM_LIMIT", 5000)
        plan = tlb.launch_plan(full_hd, 1, torch.float32)
        assert plan.variant == "scalar" and "5000" in plan.reason
    broad = tprep.letterbox_spec((8, 4096), (8, 4096))
    assert tlb.launch_plan(broad, 1, torch.float32).variant == "scalar"
    spec = tprep.letterbox_spec((540, 960), (640, 640))
    assert tlb.launch_plan(spec, 70000, torch.float32).variant == "scalar"
    # two output rows tap three source rows at this ratio; full HD to 640
    # (ratio 3) taps one row per output row with a weight above 0 and skips
    # two, so one row per block stages the least
    assert tlb.launch_plan(spec, 8, torch.bfloat16) == tlb.LaunchPlan(
        "vector", (320, 8), (80, 1), rows=2, smem_bytes=3 * 2880)
    assert tlb.launch_plan(full_hd, 8, torch.bfloat16) == tlb.LaunchPlan(
        "vector", (640, 8), (80, 1), rows=1, smem_bytes=5760)
    # narrow output rows: a block works on both rows of its tile at once
    narrow = tprep.letterbox_spec((100, 48), (128, 120))
    assert tlb.launch_plan(narrow, 3, torch.float32).block == (15, 2)
    assert tlb.launch_plan(spec, 8, torch.bfloat16,
                           variant="scalar").variant == "scalar"
    with pytest.raises(ValueError, match="vector variant"):
        tlb.launch_plan(tprep.letterbox_spec((101, 333), (640, 640)), 8,
                        torch.bfloat16, variant="vector")
    with pytest.raises(ValueError):
        tlb.launch_plan(spec, 8, torch.bfloat16, variant="tile")
    with pytest.raises(TypeError):
        tlb.launch_plan(spec, 8, torch.float16)


def _emulate_tile_kernel(frames, spec, plan):
    """The vector variant's indexing in numpy, f32, step for step: per tile
    the band of source rows between the first content row's upper tap and
    the last one's lower tap, byte offsets into it from the tables, the
    column mask, and the kernel's arithmetic order."""
    tab_i, tab_w, resize = tlb.tile_tables(spec)
    k, h, w, _ = frames.shape
    w3 = w * 3
    dh, dw = spec.out_hw
    uh, uw = spec.unpad_hw
    top, left = spec.top, spec.left
    dh4 = -(-dh // 4) * 4
    assert len(tab_i) == len(tab_w) == 2 * dh4 + 2 * dw
    xa, xb = tab_i[2 * dh4:2 * dh4 + dw], tab_i[2 * dh4 + dw:]
    wa, wb = tab_w[2 * dh4:2 * dh4 + dw], tab_w[2 * dh4 + dw:]
    inside = (np.arange(dw) - left).astype(np.uint32) < np.uint32(uw)
    pad = np.float32(114.0) / np.float32(255.0)
    flat = frames.reshape(k, h * w3)
    out = np.full((k, 3, dh, dw), np.nan, np.float32)
    for f in range(k):
        for tile in range(plan.grid[0]):
            base = tile * plan.rows
            oy_lo = max(base, top)
            oy_hi = min(base + plan.rows, dh, top + uh)
            if oy_lo < oy_hi:
                ys_lo = int(tab_i[oy_lo])
                n = (int(tab_i[dh4 + oy_hi - 1]) - ys_lo + 1) * w3
                assert n % 16 == 0 and n <= plan.smem_bytes
                band = flat[f, ys_lo * w3:ys_lo * w3 + n]
            for oy in range(base, min(base + plan.rows, dh)):
                assert np.isnan(out[f, 0, oy, 0])  # each row written once
                y0 = int(tab_i[oy])
                if y0 < 0:
                    out[f, :, oy] = pad
                    continue
                p0 = band[(y0 - ys_lo) * w3:]
                p1 = band[(int(tab_i[dh4 + oy]) - ys_lo) * w3:]
                wy0, wy1 = tab_w[oy], tab_w[dh4 + oy]
                for c in range(3):
                    t0 = (p0[xa + c].astype(np.float32) * wy0
                          + p1[xa + c].astype(np.float32) * wy1)
                    t1 = (p0[xb + c].astype(np.float32) * wy0
                          + p1[xb + c].astype(np.float32) * wy1)
                    v = t0 * wa + t1 * wb
                    if resize:
                        v = np.clip(np.rint(v), 0.0, 255.0)
                    v = (v / np.float32(255.0)).astype(np.float32)
                    out[f, 2 - c, oy] = np.where(inside, v, pad)
    return out


@pytest.mark.parametrize("src,dst,auto,rows", [
    ((54, 96), (64, 64), False, 2),
    ((108, 192), (64, 64), False, 1),        # ratio 3: weight-0 taps skipped
    ((96, 160), (64, 64), False, 1),         # ratio 2.5: two rows a row
    ((16, 128), (192, 128), False, 2),       # pad only: identity taps
    ((270, 480), (320, 320), False, 2),
    ((270, 480), (320, 320), True, 2),       # auto canvas
    ((100, 48), (128, 120), False, 2),       # left pad 36: groups straddle
    ((37, 64), (31, 40), False, 2),          # odd Dh: a ragged last tile
])
def test_tile_tables_reproduce_the_plain_letterbox(src, dst, auto, rows):
    """The vector variant's tables, band and masks, emulated in numpy with
    its indexing, against the plain version. Tolerance: bitwise. ``rows``:
    the tile height the plan picks for the shape."""
    frames = np.stack([_frame(src, s) for s in range(2)])
    spec = tprep.letterbox_spec(src, dst, auto=auto)
    plan = tlb.launch_plan(spec, 2, torch.float32)
    assert plan.variant == "vector" and plan.rows == rows, plan
    ours = _emulate_tile_kernel(frames, spec, plan)
    ref = tprep.letterbox_plain(torch.from_numpy(frames), spec).numpy()
    np.testing.assert_array_equal(ours, ref)


def _round_to_f32(x: Fraction) -> np.float32:
    """An exact rational rounded once to f32, half to even."""
    if x == 0:
        return np.float32(0)
    sign = -1 if x < 0 else 1
    x = abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    q, rem = divmod(x, ulp)
    if rem * 2 > ulp or (rem * 2 == ulp and q % 2):
        q += 1
    return np.float32(sign * float(q * ulp))


def test_vector_variant_shortcuts_are_exact():
    """The vector variant's three shortcuts over their whole domains.

    A byte times a weight: the byte read as the denormal b * 2^-149, times
    w * 2^127, equals RN(b * w) * 2^-22, so the later sums and the column
    weight times 2^22 reproduce the plain order bit for bit. Rounding:
    (v + 2^23) - 2^23 == rint(v), half to even. Division: one Newton step
    on n * RN(1/255), with fused multiply-adds, equals n / 255 correctly
    rounded for every integer 0..255 (the FMAs evaluated exactly here).
    Tolerance: bitwise."""
    b = np.arange(256, dtype=np.uint32)
    rng = np.random.RandomState(0)
    weights = np.concatenate([
        np.float32([0.0, 1.0, 0.25, 0.75, 2.0 ** -43, 1 - 2.0 ** -24]),
        tprep.resize_taps(360, 540)[2], tprep.resize_taps(333, 1999)[3],
        rng.uniform(0, 1, 500).astype(np.float32)])
    two22, two127 = np.float32(2.0 ** 22), np.float32(2.0 ** 127)
    for w in weights:
        scaled = b.view(np.float32) * (w * two127)   # the kernel's multiply
        plain = b.astype(np.float32) * w             # RN(float(b) * w)
        np.testing.assert_array_equal(scaled * two22, plain)
        np.testing.assert_array_equal(scaled, plain / two22)

    two23 = np.float32(8388608.0)
    halves = np.arange(0.5, 256, 1, dtype=np.float32)
    v = np.concatenate([np.arange(0, 256 * 64 + 1, dtype=np.float32) / 64,
                        np.nextafter(halves, np.float32(0)),
                        np.nextafter(halves, np.float32(512))])
    np.testing.assert_array_equal((v + two23) - two23, np.rint(v))

    r = np.uint32(0x3B808081).view(np.float32)
    assert r == np.float32(1) / np.float32(255)
    for n in range(256):
        q = np.float32(n) * r
        e = _round_to_f32(Fraction(-255) * Fraction(float(q)) + n)
        got = _round_to_f32(Fraction(float(e)) * Fraction(float(r))
                            + Fraction(float(q)))
        assert got == np.float32(n) / np.float32(255) \
            == _round_to_f32(Fraction(n, 255)), n


def test_wrapper_checks_arguments_and_routes_cpu_to_plain():
    spec = tprep.letterbox_spec((54, 96), (64, 64))
    good = torch.zeros((2, 54, 96, 3), dtype=torch.uint8)
    launches = tlb.KERNEL.launches
    assert tlb.letterbox(good, spec).shape == (2, 3, 64, 64)
    assert tlb.KERNEL.launches == launches  # the plain version ran
    with pytest.raises(TypeError):
        tlb.letterbox(good.float(), spec)
    with pytest.raises(ValueError):
        tlb.letterbox(good[0], spec)                       # not 4-D
    with pytest.raises(ValueError):
        tlb.letterbox(good[..., :2], spec)                 # not 3 channels
    with pytest.raises(ValueError):
        tlb.letterbox(torch.zeros((2, 50, 96, 3), dtype=torch.uint8), spec)
    with pytest.raises(ValueError):
        tlb.letterbox(good.transpose(1, 2).contiguous().transpose(1, 2),
                      spec)                                # not contiguous
    with pytest.raises(TypeError):
        tlb.letterbox(good, spec, torch.float16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tlb.KERNEL(good, spec, torch.float32)   # no plain fallback inside
    assert tlb.KERNEL.launches == launches
