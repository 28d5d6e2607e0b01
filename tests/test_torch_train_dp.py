"""Port: ``train.make_train_step_dp`` on 2 gloo ranks of the CPU, against
JAX's ``make_train_step_dp`` on a 2-device ('batch',) mesh of its virtual
CPU devices and against the port's one-process ``make_train_step``.

Sizes and tolerances are ``tests/test_train_dp_impl.py``'s: YOLOv8n (f32)
at 64x64, the 48x64 world with 4 objects, batch 8, scan 2, lr 1e-3,
warm-up 1; two dispatches from JAX's init carried across; losses within
rtol 1e-4, parameters within rtol 5e-3 and atol 1e-5 (which the starting
parameters must fail, so that the updates are real). Both trainers use the
JAX trainers' optimizer (a global-norm clip of 10 and AdamW on a warm-up
cosine schedule). The ranks run in processes of their own
(``parallel.distributed.spawn``, one intra-op thread each, a join
timeout).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aicamera_tpu_torch import prng  # noqa: E402
from aicamera_tpu_torch import train as tt  # noqa: E402
from aicamera_tpu_torch.models.yolov8 import YOLOv8  # noqa: E402
from aicamera_tpu_torch.ops.preprocess import letterbox_spec  # noqa: E402
from aicamera_tpu_torch.parallel import distributed  # noqa: E402
from aicamera_tpu_torch.runtime import params  # noqa: E402
from aicamera_tpu_torch.synthetic import WorldSpec  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


INPUT_HW = (64, 64)
WORLD_KW = dict(hw=(48, 64), max_objects=4, presence=1.0)
CFG_KW = dict(batch=8, scan=2, lr=1e-3, warmup=1)
N_DISP = 2
DECREASE_DISP = 6     # dispatches of the loss-decrease run
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 1e-5


def _model(state):
    m = YOLOv8("n")
    params.load_state_strict(m, {k: torch.from_numpy(v)
                                 for k, v in state.items()})
    return m.train()


def _port_step(model, make, total, **kw):
    cfg = tt.TrainConfig(**CFG_KW)
    tx = tt.make_optimizer(model, cfg.lr, cfg.warmup, total,
                           cfg.weight_decay)
    return make(model, WorldSpec(**WORLD_KW),
                letterbox_spec(WORLD_KW["hw"], INPUT_HW), INPUT_HW, cfg, tx,
                **kw)


def _run(step, n_disp, seed=0):
    key, losses = prng.PRNGKey(seed), []
    for _ in range(n_disp):
        key, sub = prng.split(key)
        losses.append(step(sub)[0].numpy())
    return np.concatenate(losses)


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


def _dp_world(rank, device, state):
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("batch",))
    out = {}
    model = _model(state)
    step = _port_step(model, tt.make_train_step_dp, N_DISP * CFG_KW["scan"],
                      mesh=mesh)
    distributed.COLLECTIVES.reset()
    out["losses"] = _run(step, N_DISP)
    out["collectives"] = dict(distributed.COLLECTIVES.by_kind)
    out["params"] = _state(model)
    model = _model(state)
    step = _port_step(model, tt.make_train_step_dp,
                      DECREASE_DISP * CFG_KW["scan"], mesh=mesh)
    out["decrease"] = _run(step, DECREASE_DISP, seed=1)
    try:
        tt.make_train_step_dp(
            model, WorldSpec(**WORLD_KW),
            letterbox_spec(WORLD_KW["hw"], INPUT_HW), INPUT_HW,
            tt.TrainConfig(batch=7), None, mesh)
        out["error"] = None
    except ValueError as e:
        out["error"] = str(e)
    return out


@pytest.fixture(scope="module")
def jax_run():
    """JAX's init, its DP step over two devices for two dispatches."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh
    from aicamera_tpu import train as jt
    from aicamera_tpu.models import YOLOv8 as JYOLO
    from aicamera_tpu.ops.preprocess import letterbox_spec as jspec
    from aicamera_tpu.runtime.params import template_params
    from aicamera_tpu.synthetic import WorldSpec as JWorld
    jm = JYOLO(variant="n", dtype=jnp.float32)
    p0 = jax.jit(lambda: template_params(jm, jnp.zeros((1, 64, 64, 3))))()
    cfg = jt.TrainConfig(**CFG_KW)
    total = N_DISP * cfg.scan
    sched = optax.warmup_cosine_decay_schedule(
        0.0, cfg.lr, cfg.warmup, max(total, cfg.warmup + 1), cfg.lr / 20)
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adamw(sched, weight_decay=cfg.weight_decay))
    step = jt.make_train_step_dp(
        jm, JWorld(**WORLD_KW), jspec(WORLD_KW["hw"], INPUT_HW), INPUT_HW,
        cfg, tx, Mesh(np.array(jax.devices()[:2]), ("batch",)))
    p, opt, key, losses = p0, tx.init(p0), jax.random.PRNGKey(0), []
    for _ in range(N_DISP):
        key, sub = jax.random.split(key)
        p, opt, ls, _ = step(p, opt, sub)
        losses.append(np.asarray(ls))
    to_port = params.yolo_state_dict_from_flax
    return ({k: np.asarray(v) for k, v in
             to_port(jax.tree.map(np.asarray, p0)).items()},
            {k: np.asarray(v) for k, v in
             to_port(jax.tree.map(np.asarray, p)).items()},
            np.concatenate(losses))


@pytest.fixture(scope="module")
def dp(jax_run):
    return distributed.spawn(_dp_world, 2, device="cpu", timeout=120.0,
                             args=(jax_run[0],))


def _assert_close(ours, ref):
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def test_dp_step_matches_jax_dp_step(dp, jax_run):
    start, jparams, jlosses = jax_run
    for rank in dp:
        np.testing.assert_allclose(rank["losses"], jlosses, rtol=LOSS_RTOL)
        _assert_close(rank["params"], jparams)
    with pytest.raises(AssertionError):
        _assert_close(start, jparams)


def test_dp_step_matches_one_process_step(dp, jax_run):
    model = _model(jax_run[0])
    step = _port_step(model, tt.make_train_step, N_DISP * CFG_KW["scan"])
    losses = _run(step, N_DISP)
    for rank in dp:
        np.testing.assert_allclose(rank["losses"], losses, rtol=LOSS_RTOL)
        _assert_close(rank["params"], _state(model))


def test_dp_loss_decreases(dp):
    for rank in dp:
        assert rank["decrease"][-1] < rank["decrease"][0]


def test_dp_parameters_stay_replicated(dp):
    a, b = dp[0]["params"], dp[1]["params"]
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(dp[0]["losses"], dp[1]["losses"])


def test_dp_one_all_reduce_a_step(dp):
    for rank in dp:
        assert rank["collectives"] == {"all_reduce": N_DISP * CFG_KW["scan"]}


def test_dp_batch_divisibility_validated(dp):
    for rank in dp:
        assert rank["error"] == ("cfg.batch=7 not divisible by mesh axis "
                                 "'batch' size 2")
