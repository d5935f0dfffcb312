"""The JAX package's reference values that chip_smoke.py holds the port to,
recomputed here on the CPU from chip_smoke's own recipes: each constant must
be what the JAX package gives (the chaotic spreads to rtol 0.1, since they
are the max abs difference of two f32 trajectories)."""

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
import stein_tpu as sj
from stein_tpu.models import LinearRegressionModel as JM
from stein_tpu.models import LogisticRegressionModel as JL


def _lr(theta0, sufficient=True):
    """chip_smoke's LR data, its JAX model and batch, theta0 as f32."""
    X, y, _ = cs.make_data()
    model = JM(cs.P)
    batch = {"X": jnp.asarray(X, jnp.float32), "y": jnp.asarray(y, jnp.float32)}
    if sufficient:
        batch = model.sufficient_batch(batch)
    return X, y, model, batch, jnp.asarray(theta0, jnp.float32)


def _sampler(model, theta0, gd, cfg):
    return sj.SVGDSampler(theta0.shape[0], model.log_p, model.template(), gd,
                          theta=theta0, **cfg)


def test_logreg_log_p_mean_at_step_500():
    X, y, theta0 = cs.logreg_data()
    model = JL(cs.LOGREG_D, cs.LOGREG_TRAIN, cs.LOGREG_OBS)
    cfg = sj.throughput_config(cs.LOGREG_N, cs.LOGREG_D + 1, model=model,
                               pallas_interpret=True)
    assert cfg["step_impl"] == "fused_model"
    cfg.update(median_passes=16, warm_passes=6)
    s = _sampler(model, jnp.asarray(theta0, jnp.float32),
                 sj.Adam(learning_rate=1e-1), cfg)
    aux = s.run({"X": jnp.asarray(X, jnp.float32),
                 "y": jnp.asarray(y, jnp.float32)}, cs.LOGREG_STEPS)
    assert float(aux["log_p_mean"][-1]) == pytest.approx(cs.LOGREG_LOGP_JAX,
                                                         rel=1e-5)


def test_glm_posterior_error_at_step_500():
    X, y, model, batch, theta0 = _lr(cs.make_data()[2])
    cfg = sj.throughput_config(cs.N, cs.P, model=model, pallas_interpret=True)
    assert cfg["step_impl"] == "fused_glm"
    s = _sampler(model, theta0, sj.Adam(learning_rate=1e-1), cfg)
    s.run(batch, cs.GLM_STEPS)
    post = np.linalg.solve(X.T @ X + np.eye(cs.P), X.T @ y).ravel()
    err = float(np.max(np.abs(np.asarray(s.samples).mean(0) - post)))
    assert err == pytest.approx(cs.POSTERIOR_GLM_JAX, rel=1e-3)


@pytest.mark.parametrize("case", ["glm50", "fused"])
def test_spread_of_the_jax_package_own_paths(case):
    """The max abs difference of the samples after 10 steps between the
    JAX package's xla path and its fused_glm (BASELINE #1's n=50 route) or
    fused (step_impl='fused' at n=1000) path."""
    if case == "glm50":
        theta0 = np.random.default_rng(3).normal(size=(cs.GLM50_N, cs.P))
        _, _, model, batch, theta0 = _lr(theta0 * 0.01)
        fused = sj.throughput_config(cs.GLM50_N, cs.P, model=model,
                                     pallas_interpret=True)
        xla = dict(median="bisect", warm_median=True, median_max_rows=128,
                   median_impl="fused", pallas_interpret=True)
        gd, want = (lambda: sj.Adagrad(learning_rate=0.1)), cs.GLM50_SPREAD_JAX
    else:
        _, _, model, batch, theta0 = _lr(cs.make_data()[2], sufficient=False)
        base = sj.throughput_config(cs.N, cs.P, pallas_interpret=True)
        fused, xla = dict(base, step_impl="fused"), dict(base,
                                                         step_impl="xla")
        gd, want = (lambda: sj.Adam(learning_rate=1e-1)), cs.FUSED_SPREAD_JAX
    a, b = _sampler(model, theta0, gd(), fused), _sampler(model, theta0, gd(),
                                                           xla)
    a.run(batch, 10)
    b.run(batch, 10)
    spread = float(np.abs(np.asarray(a.samples) - np.asarray(b.samples)).max())
    assert spread == pytest.approx(want, rel=0.1)


@pytest.mark.parametrize("case", ["mesh", "mesh-glm"])
def test_mesh_posterior_error_at_step_500(case):
    """[mesh] and [mesh-glm]'s recipes through the JAX package's
    throughput_config(1000, 128, mesh=) on a 1-device mesh (fused_shard,
    interpret mode), 500 steps: max |particle mean - posterior mean|."""
    import jax

    from stein_tpu.parallel import particle_mesh

    glm = case == "mesh-glm"
    X, y, model, batch, theta0 = _lr(cs.make_data()[2], sufficient=glm)
    cfg = sj.throughput_config(cs.N, cs.P, pallas_interpret=True,
                               mesh=particle_mesh(jax.devices()[:1]),
                               model=model if glm else None)
    assert cfg["step_impl"] == "fused_shard"
    assert ("quadratic_form" in cfg) == glm
    s = _sampler(model, theta0, sj.Adam(learning_rate=1e-1), cfg)
    s.run(batch, cs.MESH_STEPS)
    post = np.linalg.solve(X.T @ X + np.eye(cs.P), X.T @ y).ravel()
    err = float(np.max(np.abs(np.asarray(s.samples).mean(0) - post)))
    want = cs.POSTERIOR_MESH_GLM_JAX if glm else cs.POSTERIOR_MESH_JAX
    assert err == pytest.approx(want, rel=1e-3)


def test_pblock_nn_log_p_mean_at_step_500():
    """[main-nn-pblock]'s loop in the JAX package: per step B7's gradients
    (pallas_grads(interpret=True)), then fused_warm_step_pblock(
    interpret=True), med starting at 0, Adam(0.1, decay=0.999), 500 steps
    under jax.jit (~50 ms a step here); the mean log_p of the 500th
    gradient call."""
    import jax

    from stein_tpu.models import BayesianNNModel as JNN
    from stein_tpu.ops.pallas_step import fused_warm_step_pblock

    X, y, theta0 = cs.nn_data(cs.NN_N)
    model = JNN(1, 100, 20, 20, prior_beta=10.0)
    gd = sj.Adam(learning_rate=0.1, decay=0.999)
    grad_fn = model.pallas_grads(interpret=True)
    batch = {"X": jnp.asarray(X, jnp.float32),
             "y": jnp.asarray(y, jnp.float32)}

    @jax.jit
    def step(theta, opt, med):
        logp, grads = grad_fn(theta, batch)
        theta, opt, (med, _, _) = fused_warm_step_pblock(
            theta, grads, med, opt, gd, interpret=True)
        return theta, opt, med, jnp.mean(logp)

    theta = jnp.asarray(theta0, jnp.float32)
    opt = gd.init(theta.shape, jnp.float32)
    med = jnp.float32(0.0)
    for _ in range(cs.PBLOCK_STEPS):
        theta, opt, med, lp = step(theta, opt, med)
    assert float(lp) == pytest.approx(cs.NN_PBLOCK_LOGP_JAX, rel=1e-5)


@pytest.mark.parametrize("case", ["main-nn", "mesh-nn", "main-nn-bf16"])
def test_nn_log_p_mean_at_step_500(case):
    """[main-nn]'s recipe through the JAX package's throughput_config(1000,
    303, model=BayesianNNModel(...), pallas_interpret=True): custom_grads
    (B7's pallas_grads), the streaming tile (B3) and the 128-row fused_gram
    median; [mesh-nn]'s on a one-device mesh (fused_shard); [main-nn-bf16]'s
    with pallas_precision='bf16' (interpret mode rounds the tile's operands
    to bf16). Adam(0.1, decay=0.999), 500 steps of run(); the mean log_p of
    the last step."""
    import jax

    from stein_tpu.models import BayesianNNModel as JNN
    from stein_tpu.parallel import particle_mesh

    X, y, theta0 = cs.nn_data(cs.NN_N)
    model = JNN(1, 100, 20, 20, prior_beta=10.0)
    mesh = particle_mesh(jax.devices()[:1]) if case == "mesh-nn" else None
    cfg = sj.throughput_config(cs.NN_N, cs.NN_P, model=model, mesh=mesh,
                               pallas_interpret=True)
    assert cfg["step_impl" if mesh else "kernel_impl"] == (
        "fused_shard" if mesh else "pallas")
    if case == "main-nn-bf16":
        cfg["pallas_precision"] = "bf16"
    s = _sampler(model, jnp.asarray(theta0, jnp.float32),
                 sj.Adam(learning_rate=0.1, decay=0.999), cfg)
    aux = s.run({"X": jnp.asarray(X, jnp.float32),
                 "y": jnp.asarray(y, jnp.float32)}, cs.NN_STEPS)
    want = {"main-nn": cs.NN_LOGP_JAX, "mesh-nn": cs.NN_MESH_LOGP_JAX,
            "main-nn-bf16": cs.NN_BF16_LOGP_JAX}[case]
    assert float(aux["log_p_mean"][-1]) == pytest.approx(want, rel=1e-5)
