"""Port: training (``train.py``, ``train_synthetic.py``, ``prng.normal``) on
the CPU against the JAX package.

Inputs come from numpy seeds or from ``prng`` keys equal to JAX's; JAX runs
on its CPU backend. The steps start from JAX's init carried across and hold
the port to JAX within the tolerances ``tests/test_train_dp_impl.py`` holds
the JAX program to across reduction orders: losses within rtol 1e-4,
parameters within rtol 5e-3 and atol 1e-5.
"""

import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from aicamera_tpu import train as jt  # noqa: E402
from aicamera_tpu.models import ReIDNet as JReID  # noqa: E402
from aicamera_tpu.models import YOLOv8 as JYOLO  # noqa: E402
from aicamera_tpu.ops.preprocess import letterbox_spec as jspec  # noqa: E402
from aicamera_tpu.runtime.params import template_params  # noqa: E402
from aicamera_tpu.synthetic import WorldSpec as JWorld  # noqa: E402
from aicamera_tpu_torch import config, prng  # noqa: E402
from aicamera_tpu_torch import train as tt  # noqa: E402
from aicamera_tpu_torch import train_synthetic as tts  # noqa: E402
from aicamera_tpu_torch.models.reid import ReIDNet  # noqa: E402
from aicamera_tpu_torch.models.yolov8 import YOLOv8  # noqa: E402
from aicamera_tpu_torch.ops.preprocess import letterbox_spec  # noqa: E402
from aicamera_tpu_torch.runtime import params  # noqa: E402
from aicamera_tpu_torch.synthetic import WorldSpec  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_train_dp_impl.py's sizes
INPUT_HW = (64, 64)
WORLD_KW = dict(hw=(48, 64), max_objects=4, presence=1.0)
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 1e-5


def _ulps(a, b):
    """Distance in float32 units in the last place."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_params_close(model, jax_params):
    ours = params.flax_tree(model)["params"]
    ref = _np_tree(jax_params)["params"]

    def walk(a, b, path):
        assert set(a) == set(b), path
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k], path + (k,))
            else:
                np.testing.assert_allclose(
                    a[k], b[k], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                    err_msg="/".join(path + (k,)))
    walk(ours, ref, ())


def _jax_tx(lr, warmup, total, weight_decay):
    """The optimizer the JAX trainers build."""
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(total, warmup + 1), lr / 20)
    return optax.chain(optax.clip_by_global_norm(10.0),
                       optax.adamw(sched, weight_decay=weight_decay))


# --- prng.normal ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 4), (12, 4), (3,)])
def test_normal_is_jax_bitwise(shape):
    """The shapes the ReID trainer draws in the default world (its box
    jitter), over 16 keys: bitwise (but see the next test)."""
    for seed in range(16):
        key = np.array([seed, 1000 + seed], np.uint32)
        np.testing.assert_array_equal(
            prng.normal(key, shape, device="cpu").numpy(),
            np.asarray(jax.random.normal(jnp.asarray(key), shape)))


def test_normal_on_many_draws():
    """Over 6e5 draws all but about one in 1e5 are bitwise JAX's; those few
    are 1-2 ulps off (tails with |u| > 0.996, where XLA's fused erf_inv
    takes a log one ulp away from its standalone log; measured: 30 of
    3.0e6 draws, and 1 of 8192 draws of shape (128, 4))."""
    tot = bad = 0
    for seed in range(2):
        key = np.array([seed, 7 * seed + 1], np.uint32)
        for shape in ((100003,), (512, 300)):
            d = _ulps(prng.normal(key, shape, device="cpu").numpy(),
                      jax.random.normal(jnp.asarray(key), shape))
            assert d.max() <= 2
            tot += d.size
            bad += int((d > 0).sum())
    assert bad <= 3e-5 * tot


# --- targets and losses -----------------------------------------------------


def _gt(seed, n=12, hw=(540, 960)):
    """Boxes with two gts in one cell, a duplicate, tiny and invalid ones."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-50, hw[1] - 60, n)
    y1 = rng.uniform(-50, hw[0] - 40, n)
    b = np.stack([x1, y1, x1 + rng.uniform(0.5, 400, n),
                  y1 + rng.uniform(0.5, 300, n)], -1).astype(np.float32)
    b[:, 0::2] = np.clip(b[:, 0::2], 0, hw[1])
    b[:, 1::2] = np.clip(b[:, 1::2], 0, hw[0])
    b[5] = b[3] + np.float32(0.5)     # same cell as gt 3, later index
    b[7] = b[3]                       # a duplicate of gt 3
    cls = rng.choice([0, 2, 3, 5, 7], n).astype(np.int32)
    valid = rng.uniform(size=n) < 0.8
    valid[[3, 5, 7]] = True
    return b, cls, valid


@pytest.mark.parametrize("hw,input_hw", [((540, 960), (640, 640)),
                                         ((48, 64), (64, 64))])
def test_build_targets_bitwise(hw, input_hw):
    """Equal to JAX's ``build_targets`` run op by op, every op rounded on
    its own (collisions: the class targets by max, the box target by the
    highest gt index, as XLA's CPU scatter resolves them). Against the
    jitted function the anchors, classes and positives are equal and the
    box targets (at most 14.99) within 4e-6: XLA fuses some of the
    coordinate multiply-adds."""
    tspec, jsp = letterbox_spec(hw, input_hw), jspec(hw, input_hw)
    jit_fn = jax.jit(jt.build_targets, static_argnums=(3, 4))
    batch = []
    for seed in range(6):
        b, c, v = _gt(seed, hw=hw)
        ours = tt.build_targets(torch.from_numpy(b), torch.from_numpy(c),
                                torch.from_numpy(v), tspec, input_hw)
        args = (jnp.asarray(b), jnp.asarray(c), jnp.asarray(v), jsp,
                input_hw)
        for o, r in zip(ours, jt.build_targets(*args)):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        jc, jb, jp = map(np.asarray, jit_fn(*args))
        np.testing.assert_array_equal(ours[0].numpy(), jc)
        np.testing.assert_array_equal(ours[2].numpy(), jp)
        np.testing.assert_allclose(ours[1].numpy(), jb, rtol=0, atol=4e-6)
        batch.append((b, c, v, ours))
    assert sum(int(o[2].sum()) for *_, o in batch) > 0
    # batched: the same targets per image
    b, c, v = (torch.from_numpy(np.stack(x)) for x in zip(
        *[t[:3] for t in batch]))
    for i, o in enumerate(tt.build_targets(b, c, v, tspec, input_hw)):
        for j, (*_, one) in enumerate(batch):
            assert torch.equal(o[j], one[i])


def _assert_grad_close(ours, ref, rtol=1e-5):
    """Within ``rtol`` of the largest entry."""
    np.testing.assert_allclose(ours, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _levels(rng, bsz, input_hw, scale=2.0):
    out = []
    for s in (8, 16, 32):
        h, w = input_hw[0] // s, input_hw[1] // s
        out.append((rng.normal(0, scale, (bsz, h, w, 64)).astype(np.float32),
                    rng.normal(-2, scale, (bsz, h, w, 80)).astype(
                        np.float32)))
    return out


def test_detection_loss_value_and_grad():
    """Per-image loss, its parts and the gradient wrt every head output
    equal ``jax.value_and_grad`` of JAX's loss within rtol 1e-5 (of the
    largest entry, for the gradients: small entries are differences of
    nearly equal terms, rounded in another order)."""
    rng = np.random.default_rng(0)
    hw, input_hw = (48, 64), INPUT_HW
    levels = _levels(rng, 2, input_hw)
    cfg_t, cfg_j = tt.TrainConfig(), jt.TrainConfig()
    gts = [_gt(s, n=8, hw=hw) for s in (1, 2)]
    tspec, jsp = letterbox_spec(hw, input_hw), jspec(hw, input_hw)
    tl = [(torch.from_numpy(bb).requires_grad_(),
           torch.from_numpy(cl).requires_grad_()) for bb, cl in levels]
    targets = tt.build_targets(*(torch.from_numpy(np.stack(x))
                                 for x in zip(*gts)), tspec, input_hw)
    loss, aux = tt.detection_loss(tl, *targets, cfg_t)
    loss.sum().backward()
    for i, (b, c, v) in enumerate(gts):
        jtargets = jt.build_targets(jnp.asarray(b), jnp.asarray(c),
                                    jnp.asarray(v), jsp, input_hw)
        jlev = [(jnp.asarray(bb[i:i + 1]), jnp.asarray(cl[i:i + 1]))
                for bb, cl in levels]
        (jl, jaux), jg = jax.value_and_grad(
            lambda lv: jt.detection_loss(lv, *jtargets, cfg_j),
            has_aux=True)(jlev)
        np.testing.assert_allclose(loss[i].item(), float(jl), rtol=1e-5)
        for k in ("cls", "iou", "dfl"):
            np.testing.assert_allclose(aux[k][i].item(), float(jaux[k]),
                                       rtol=1e-5)
        for (gb, gc), (tb, tc) in zip(jg, tl):
            for g, t in ((gb, tb), (gc, tc)):
                _assert_grad_close(t.grad[i].numpy(), np.asarray(g)[0])


def test_reid_contrastive_loss_value_and_grad():
    """Value within rtol 1e-5, gradients within rtol 1e-5 of the largest
    entry (the positives dominate at temperature 0.1, so an entry is
    ``p_ii - 1`` times a feature plus small terms)."""
    rng = np.random.default_rng(1)
    m, d = 12, 32
    za = rng.normal(size=(m, d)).astype(np.float32)
    zb = (za + 0.5 * rng.normal(size=(m, d))).astype(np.float32)
    za /= np.linalg.norm(za, axis=1, keepdims=True)
    zb /= np.linalg.norm(zb, axis=1, keepdims=True)
    valid = rng.uniform(size=m) < 0.75
    jl, (ga, gb) = jax.value_and_grad(
        lambda a, b: jt.reid_contrastive_loss(a, b, jnp.asarray(valid), 0.1),
        argnums=(0, 1))(jnp.asarray(za), jnp.asarray(zb))
    ta = torch.from_numpy(za).requires_grad_()
    tb = torch.from_numpy(zb).requires_grad_()
    loss = tt.reid_contrastive_loss(ta, tb, torch.from_numpy(valid), 0.1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _assert_grad_close(ta.grad.numpy(), np.asarray(ga))
    _assert_grad_close(tb.grad.numpy(), np.asarray(gb))


# --- optimizer -----------------------------------------------------------


@pytest.mark.parametrize("lr,warmup,total", [(2e-3, 200, 3000),
                                             (1e-3, 2, 5), (5e-4, 1, 4)])
def test_schedule_matches_optax(lr, warmup, total):
    """The first update at 0, the cosine horizon counting the warm-up."""
    sched = tt.warmup_cosine_schedule(lr, warmup, max(total, warmup + 1),
                                      lr / 20)
    ref = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(total, warmup + 1), lr / 20)
    counts = sorted(set(range(0, min(total, 12))) | {
        warmup - 1, warmup, warmup + 1, total // 2, total - 1, total,
        total + 5})
    for c in counts:
        np.testing.assert_allclose(sched(c), float(ref(c)), rtol=1e-6,
                                   atol=0, err_msg=f"count {c}")
    assert sched(0) == 0.0


def test_clip_and_adamw_match_optax():
    """Five fixed gradients through the optimizer, the clip active on some
    (global norm above 10) and not on others; weight decay on every
    parameter, biases included. Parameters after each step within rtol
    1e-6."""
    rng = np.random.default_rng(2)
    shapes = {"a": (4, 3), "b": (3,), "c": (2, 2, 2)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()}
             for scale in (0.5, 20.0, 1.0, 8.0, 0.01)]
    tx = _jax_tx(1e-2, 2, 5, 1e-2)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in init.items()})
    opt = tt.make_optimizer(module, 1e-2, 2, 5, 1e-2)
    for g in grads:
        norm = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                                 for x in g.values())))
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        clipped, _ = optax.clip_by_global_norm(10.0).update(jg, None)
        ours = [torch.from_numpy(g[k].copy()) for k in shapes]
        tnorm = tt.clip_by_global_norm_(ours, 10.0)
        np.testing.assert_allclose(tnorm.item(), norm, rtol=1e-6)
        for k, t in zip(shapes, ours):
            np.testing.assert_allclose(t.numpy(), np.asarray(clipped[k]),
                                       rtol=1e-6)
        updates, state = tx.update(jg, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6)
    assert opt.count == 5


# --- the steps: detector, ReID, clip ----------------------------------------


def _run_jax(step, params_, opt_state, n_disp, *args):
    key, losses = jax.random.PRNGKey(0), []
    for _ in range(n_disp):
        key, sub = jax.random.split(key)
        out = step(params_, opt_state, sub, *args)
        params_, opt_state = out[:2]
        losses.append(np.asarray(out[2]))
    return params_, np.concatenate(losses)


def _run_port(step, n_disp, *args):
    key, losses = prng.PRNGKey(0), []
    for _ in range(n_disp):
        key, sub = prng.split(key)
        out = step(sub, *args)
        losses.append((out[0] if isinstance(out, tuple) else out).numpy())
    return np.concatenate(losses)


def _jax_init(model, shape):
    """JAX's init (``template_params``), compiled as one program (an eager
    call compiles a draw per leaf shape: 33 s for YOLOv8n on one core)."""
    return jax.jit(lambda: template_params(model, jnp.zeros(shape)))()


@pytest.fixture(scope="module")
def yolo_init():
    """JAX's init of YOLOv8n (f32) and the port's module carrying it."""
    jm = JYOLO(variant="n", dtype=jnp.float32)
    p = _jax_init(jm, (1, 64, 64, 3))

    def port():
        m = YOLOv8("n")
        params.load_state_strict(m, params.yolo_state_dict_from_flax(
            _np_tree(p)))
        return m
    return jm, p, port


def test_detector_step_matches_jax(yolo_init):
    """Two dispatches of two steps, batch 2, warm-up 1: every scene is
    JAX's, one letterbox launch a step."""
    jm, p0, port = yolo_init
    kw = dict(batch=2, scan=2, lr=1e-3, warmup=1, steps=4)
    jcfg, tcfg = jt.TrainConfig(**kw), tt.TrainConfig(**kw)
    tx = _jax_tx(1e-3, 1, 4, jcfg.weight_decay)
    step = jt.make_train_step(jm, JWorld(**WORLD_KW),
                              jspec(WORLD_KW["hw"], INPUT_HW), INPUT_HW,
                              jcfg, tx)
    jparams, jlosses = _run_jax(step, p0, tx.init(p0), 2)

    model = port()
    opt = tt.make_optimizer(model, 1e-3, 1, 4, tcfg.weight_decay)
    tstep = tt.make_train_step(model, WorldSpec(**WORLD_KW),
                               letterbox_spec(WORLD_KW["hw"], INPUT_HW),
                               INPUT_HW, tcfg, opt)
    launches = []
    orig = tt.letterbox
    tt.letterbox = lambda f, *a: launches.append(f.shape[0]) or orig(f, *a)
    try:
        losses = _run_port(tstep, 2)
    finally:
        tt.letterbox = orig
    assert launches == [2] * 4
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    _assert_params_close(model, jparams)


def test_reid_step_matches_jax():
    """Two dispatches of two steps on two scenes of four objects, at the
    trainer's default warm-up of 100. (At a warm-up of 1 the second step
    takes a full-size step on every parameter, and Adam turns gradient
    elements near zero, whose sign is rounding noise in the embedder's
    deep layers, into full steps: the port against itself with its
    weights scaled by 1 + 1e-7 then differs by 1.5e-3 after four steps.)"""
    kw = dict(scenes=2, scan=2, steps=4)
    jcfg, tcfg = jt.ReIDTrainConfig(**kw), tt.ReIDTrainConfig(**kw)
    world = dict(WORLD_KW, hw=(96, 128))
    jm = JReID(feature_dim=512, dtype=jnp.float32)
    p0 = _jax_init(jm, (1, 128, 64, 3))
    tx = _jax_tx(jcfg.lr, jcfg.warmup, 4, jcfg.weight_decay)
    step = jt.make_reid_train_step(jm, JWorld(**world), jcfg, tx)
    jparams, jlosses = _run_jax(step, p0, tx.init(p0), 2)

    model = ReIDNet(512)
    params.load_state_strict(model, params.reid_state_dict_from_flax(
        _np_tree(p0)))
    opt = tt.make_optimizer(model, tcfg.lr, tcfg.warmup, 4,
                            tcfg.weight_decay)
    tstep = tt.make_reid_train_step(model, WorldSpec(**world), tcfg, opt)
    np.testing.assert_allclose(_run_port(tstep, 2), jlosses,
                               rtol=LOSS_RTOL)
    _assert_params_close(model, jparams)


def test_clip_step_matches_jax(yolo_init):
    """A labelled 5-frame clip of another size than the synthetic world,
    batch 3 (1 clip image, round(1.5) = 2 synthetic): flips, gain and bias,
    two letterbox launches a step."""
    jm, p0, port = yolo_init
    rng = np.random.default_rng(0)
    n, m, hw = 5, 3, (40, 72)
    frames = rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
    x1, y1 = rng.uniform(0, 40, (n, m)), rng.uniform(0, 20, (n, m))
    boxes = np.stack([x1, y1, x1 + rng.uniform(5, 30, (n, m)),
                      y1 + rng.uniform(5, 18, (n, m))], -1).astype(np.float32)
    cls = rng.choice([0, 2, 5], (n, m)).astype(np.int32)
    valid = rng.uniform(size=(n, m)) < 0.8
    kw = dict(batch=3, scan=2, lr=1e-3, steps=4)
    jcfg, tcfg = jt.TrainConfig(**kw), tt.TrainConfig(**kw)
    tx = _jax_tx(1e-3, jcfg.warmup, 4, jcfg.weight_decay)
    step = jt.make_clip_train_step(jm, jspec(hw, INPUT_HW), INPUT_HW, jcfg,
                                   tx, synthetic_world=JWorld(**WORLD_KW))
    jparams, jlosses = _run_jax(step, p0, tx.init(p0), 2, *map(
        jnp.asarray, (frames, boxes, cls, valid)))

    model = port()
    opt = tt.make_optimizer(model, 1e-3, tcfg.warmup, 4, tcfg.weight_decay)
    tstep = tt.make_clip_train_step(model, letterbox_spec(hw, INPUT_HW),
                                    INPUT_HW, tcfg, opt,
                                    synthetic_world=WorldSpec(**WORLD_KW))
    launches = []
    orig = tt.letterbox
    tt.letterbox = lambda f, *a: launches.append(f.shape[0]) or orig(f, *a)
    try:
        losses = _run_port(tstep, 2, *map(torch.from_numpy,
                                          (frames, boxes, cls, valid)))
    finally:
        tt.letterbox = orig
    assert launches == [1, 2] * 4
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    _assert_params_close(model, jparams)


def _dp_world_of_one(rank, device, state):
    """A 1-rank ('batch',) world: two dispatches of the DP step."""
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    model = YOLOv8("n")
    params.load_state_strict(model, state)
    kw = dict(batch=2, scan=2, lr=1e-3, warmup=1, steps=4)
    cfg = tt.TrainConfig(**kw)
    opt = tt.make_optimizer(model, 1e-3, 1, 4, cfg.weight_decay)
    step = tt.make_train_step_dp(
        model, WorldSpec(**WORLD_KW), letterbox_spec(WORLD_KW["hw"],
                                                     INPUT_HW),
        INPUT_HW, cfg, opt, DeviceMesh("cpu", torch.arange(1),
                                       mesh_dim_names=("batch",)))
    return _run_port(step, 2), params.flax_tree(model)


def test_make_train_step_dp_is_not_ported(yolo_init):
    """Once not ported, the data-parallel step now runs: on a world of
    one rank it trains as ``make_train_step`` does (two dispatches from
    JAX's init, within the tolerances above). Two ranks against JAX's DP
    step: ``tests/test_torch_train_dp.py``."""
    from aicamera_tpu_torch.parallel import distributed
    _, p0, port = yolo_init
    kw = dict(batch=2, scan=2, lr=1e-3, warmup=1, steps=4)
    tcfg = tt.TrainConfig(**kw)
    model = port()
    opt = tt.make_optimizer(model, 1e-3, 1, 4, tcfg.weight_decay)
    want = _run_port(tt.make_train_step(
        model, WorldSpec(**WORLD_KW), letterbox_spec(WORLD_KW["hw"],
                                                     INPUT_HW),
        INPUT_HW, tcfg, opt), 2)
    state = params.yolo_state_dict_from_flax(_np_tree(p0))
    [(losses, tree)] = distributed.spawn(_dp_world_of_one, 1, device="cpu",
                                         timeout=120.0, args=(state,))
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    _assert_params_close(model, tree)


# --- evaluation, checkpoints and entry points ---------------------------------


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_synthetic", config.PROJECT_ROOT / "scripts" /
        "train_synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_evaluate_matches_jax_script():
    """8 scenes of the default world at 640x640 with the committed
    checkpoint in f32: the same matches, AP within 1e-6."""
    from aicamera_tpu.runtime.params import resolve_yolo_params
    jm, jp = resolve_yolo_params("n", weights_path=str(
        config.YOLO_SYNTHETIC_PATH), dtype=jnp.float32)
    ref = _jax_script().evaluate(jm, jp, JWorld(), (640, 640), n_scenes=8)
    model = params.resolve_yolo_params(
        "n", weights_path=str(config.YOLO_SYNTHETIC_PATH), device="cpu")
    ours = tts.evaluate(model, WorldSpec(), (640, 640), n_scenes=8)
    assert ours[2:5] == ref[2:5]                   # tp, fp, fn
    assert ours[2] > 0
    np.testing.assert_allclose(ours[:2], ref[:2], rtol=0, atol=0)
    for k in ("ap50", "ap75", "map_5095"):
        np.testing.assert_allclose(getattr(ours[5], k), getattr(ref[5], k),
                                   atol=1e-6)


def test_train_detector_on_the_cpu_saves_what_jax_loads(tmp_path, capsys):
    """The entry point on the CPU: one dispatch, one read of its losses;
    the msgpack it saves loads in JAX and gives the same outputs."""
    reads = tt.TRAIN_SYNCS.count
    model = tt.train_detector(
        world=WorldSpec(**WORLD_KW), input_hw=INPUT_HW,
        cfg=tt.TrainConfig(batch=2, scan=2, steps=2, warmup=1),
        device="cpu")
    assert tt.TRAIN_SYNCS.count == reads + 1
    assert "step     2/2" in capsys.readouterr().out
    path = tmp_path / "yolo.msgpack"
    tts._save(model, path)
    from aicamera_tpu.runtime.params import resolve_yolo_params
    jm, jp = resolve_yolo_params("n", weights_path=str(path),
                                 dtype=jnp.float32)
    x = np.random.default_rng(3).random((1, 64, 64, 3), np.float32)
    ref = jm.apply(jp, jnp.asarray(x))
    with torch.no_grad():
        ours = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for (a, b), (c, d) in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(b.numpy(), np.asarray(d), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("entry", ["train_detector", "train_reid",
                                   "finetune_on_clip", "main"])
def test_entry_points_default_to_the_gpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error cannot be shown")
    calls = {
        "train_detector": lambda: tt.train_detector(),
        "train_reid": lambda: tt.train_reid(),
        "finetune_on_clip": lambda: tt.finetune_on_clip(
            np.zeros((1, 48, 64, 3), np.uint8), np.zeros((1, 1, 4)),
            np.zeros((1, 1)), np.zeros((1, 1), bool), YOLOv8("n")),
        "main": lambda: tts.main(["--eval-only"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
