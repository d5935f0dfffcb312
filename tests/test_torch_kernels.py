"""The port's kernel layer (stein_tpu_torch/kernels), the sampler's
kernel= routing, the reference-compatible shims (samplers, optimizers,
utilities) and throughput_config(probe_batch=) against the JAX package's,
on the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import stein_tpu as sj
import stein_tpu_torch as st
from baselines import numpy_svgd
from stein_tpu import kernels as jk
from stein_tpu import optimizers as jopt
from stein_tpu import samplers as jsam
from stein_tpu import utilities as ju
from stein_tpu.models import LinearRegressionModel as JLR
from stein_tpu.ops import rbf as jrbf
from stein_tpu.ops.pallas_step import InKernelModel as JIK
from stein_tpu.parallel import particle_mesh as jax_mesh
from stein_tpu_torch import kernels as tk
from stein_tpu_torch import utilities as tu
from stein_tpu_torch.models import BayesianNNModel as TNN
from stein_tpu_torch.models import LinearRegressionModel as TLR
from stein_tpu_torch.models import LogisticRegressionModel as TL
from stein_tpu_torch.ops import rbf as trbf
from stein_tpu_torch.ops.fused_step import InKernelModel as TIK
from torch_mesh_runner import one_process_mesh

REF_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_rbf_kernel_and_repulse_matches_jax_and_oracle():
    """ops.rbf.rbf_kernel_and_repulse and SquaredExponentialKernel's
    kernel_and_grad against the JAX package's and the oracle's (f64,
    tests/test_kernels.py's rtol 1e-9 for K, 1e-8 / atol 1e-12 for dK)."""
    theta = np.random.default_rng(0).normal(size=(20, 5))
    K_np, dK_np, h2_np = numpy_svgd.rbf_kernel_and_repulse(theta)
    K, dK, h2 = trbf.rbf_kernel_and_repulse(_t(theta))
    Kj, dKj, h2j = jrbf.rbf_kernel_and_repulse(jnp.asarray(theta))
    for got, want in ((K, K_np), (K, Kj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    for got, want in ((dK, dK_np), (dK, dKj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                                   atol=1e-12)
    np.testing.assert_allclose(float(h2), float(h2j), rtol=1e-12)
    K2, dK2 = tk.SquaredExponentialKernel().kernel_and_grad(_t(theta))
    assert torch.equal(K2, K) and torch.equal(dK2, dK)


@pytest.mark.parametrize("c,beta", [(1.0, -0.5), (0.5, -1.5), (-2.0, -0.3)])
def test_imq_kernel_and_grad_matches_jax_and_autodiff(c, beta):
    """InverseMultiquadricKernel's (K, dK) against JAX's (f64 rtol 1e-9),
    and dK against -0.5 x the autodiff gradient of sum(K) at the same
    bandwidth (tests/test_kernels.py's rtol 1e-8 / atol 1e-12)."""
    theta = np.random.default_rng(1).normal(size=(12, 4))
    kern = tk.InverseMultiquadricKernel(c=c, beta=beta)
    K, dK = kern.kernel_and_grad(_t(theta))
    Kj, dKj = jk.InverseMultiquadricKernel(c=c, beta=beta).kernel_and_grad(
        jnp.asarray(theta))
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-9)
    np.testing.assert_allclose(dK.numpy(), np.asarray(dKj), rtol=1e-9,
                               atol=1e-12)
    th = _t(theta)
    D = trbf.pairwise_sq_dists(th)
    h2 = trbf.bandwidth_sq_from_median(tu.compute_median(D), 12)

    def sum_K(t):
        r = torch.sum(t * t, dim=1, keepdim=True)
        Dm = r + r.T - 2.0 * t @ t.T
        return torch.sum((c ** 2 + Dm / h2) ** beta)
    auto = torch.func.grad(sum_K)(th)
    np.testing.assert_allclose(dK.numpy(), -0.5 * auto.numpy(), rtol=1e-8,
                               atol=1e-12)


@pytest.mark.parametrize("kind", ["se", "imq"])
@pytest.mark.parametrize("dtype,tol", [
    (np.float64, dict(rtol=1e-9, atol=1e-13)),
    (np.float32, dict(rtol=1e-5, atol=1e-6))])
def test_generic_phi_matches_jax(kind, dtype, tol):
    """generic_svgd_phi against JAX's, both kernels, f64 at
    tests/test_kernels.py's rtol 1e-9 / atol 1e-13 and f32 at the
    reference path's tolerance; with the SE kernel it also equals the
    fused ops.rbf.svgd_phi at the same tolerance, h2 at rtol 1e-12."""
    rng = np.random.default_rng(2)
    theta = rng.normal(size=(24, 6)).astype(dtype)
    grads = rng.normal(size=(24, 6)).astype(dtype)
    tkern, jkern = ((tk.SquaredExponentialKernel(),
                     jk.SquaredExponentialKernel()) if kind == "se" else
                    (tk.InverseMultiquadricKernel(),
                     jk.InverseMultiquadricKernel()))
    phi, aux = tk.generic_svgd_phi(tkern, _t(theta), _t(grads))
    phij, auxj = jk.generic_svgd_phi(jkern, jnp.asarray(theta),
                                     jnp.asarray(grads))
    np.testing.assert_allclose(phi.numpy(), np.asarray(phij), **tol)
    np.testing.assert_allclose(float(aux["h2"]), float(auxj["h2"]),
                               rtol=1e-12 if dtype == np.float64 else 1e-6)
    if kind == "se":
        fused, faux = trbf.svgd_phi(_t(theta), _t(grads))
        np.testing.assert_allclose(phi.numpy(), fused.numpy(), **tol)
        np.testing.assert_allclose(float(aux["h2"]), float(faux["h2"]),
                                   rtol=1e-12)


@pytest.mark.parametrize("kw,match", [
    (dict(beta=0.5), "beta < 0"), (dict(beta=0.0), "beta < 0"),
    (dict(c=0.0), "c != 0")])
def test_imq_guards(kw, match):
    """tests/test_kernels.py::test_imq_invalid_params_raise on the port; a
    nonzero negative c is accepted."""
    with pytest.raises(ValueError, match=match):
        jk.InverseMultiquadricKernel(**kw)
    with pytest.raises(ValueError, match=match):
        tk.InverseMultiquadricKernel(**kw)
    tk.InverseMultiquadricKernel(c=-1.0)


def _lr_problem(n=48, p=6, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(80, p)).astype(np.float32)
    y = (X @ rng.normal(size=(p, 1))
         + rng.normal(size=(80, 1)) * 0.3).astype(np.float32)
    theta0 = (rng.normal(size=(n, p)) * 0.1).astype(np.float32)
    return ({"X": jnp.asarray(X), "y": jnp.asarray(y)},
            {"X": _t(X), "y": _t(y)}, theta0)


@pytest.mark.parametrize("median", ["exact", "bisect"])
def test_imq_sampler_matches_jax(median):
    """SVGDSampler(kernel=InverseMultiquadricKernel()) against the JAX
    sampler, 10 steps of run() at the reference-semantics class (rtol
    1e-5 / atol 1e-6), the medians at rtol 1e-5."""
    jb, tb, theta0 = _lr_problem()
    js = sj.SVGDSampler(48, JLR(6).log_p, JLR(6).template(jnp.float32),
                        sj.Adam(1e-1), theta=jnp.asarray(theta0),
                        dtype=jnp.float32, median=median,
                        kernel=jk.InverseMultiquadricKernel())
    ts = st.SVGDSampler(48, TLR(6).log_p, TLR(6).template(), st.Adam(1e-1),
                        theta=theta0, device="cpu", median=median,
                        kernel=st.InverseMultiquadricKernel())
    ja, ta = js.run(jb, 10), ts.run(tb, 10)
    np.testing.assert_allclose(ts.samples, np.asarray(js.samples), **REF_TOL)
    np.testing.assert_allclose(ta["median"].numpy(), np.asarray(ja["median"]),
                               rtol=1e-5)


def test_rbf_routing_is_by_exact_type():
    """tests/test_kernels.py::test_rbf_subclass_routes_to_generic_path on
    the port: kernel=SquaredExponentialKernel() is the default path (bitwise
    equal to kernel=None, and so it may run warm and fused), a subclass with
    its own weights() takes the generic path and follows them (equal to the
    IMQ sampler, f64 rtol 1e-12), away from the RBF trajectory."""

    @dataclasses.dataclass(frozen=True)
    class ImqViaRbfSubclass(tk.SquaredExponentialKernel):
        def weights(self, D, h2):
            return tk.InverseMultiquadricKernel().weights(D, h2)

    rng = np.random.default_rng(3)
    X = rng.normal(size=(20, 3))
    y = X @ rng.normal(size=(3, 1))
    tb = {"X": _t(X), "y": _t(y)}
    theta0 = rng.normal(size=(8, 3)) * 0.01

    def make(kernel, **kw):
        return st.SVGDSampler(8, TLR(3).log_p, TLR(3).template(torch.float64),
                              st.Adam(1e-1), theta=theta0,
                              dtype=torch.float64, device="cpu",
                              kernel=kernel, **kw)
    sub, imq = make(ImqViaRbfSubclass()), make(tk.InverseMultiquadricKernel())
    rbf_s, none = make(tk.SquaredExponentialKernel()), make(None)
    for s in (sub, imq, rbf_s, none):
        s.run(tb, 3)
    np.testing.assert_allclose(sub.samples, imq.samples, rtol=1e-12)
    np.testing.assert_array_equal(rbf_s.samples, none.samples)
    assert np.abs(sub.samples - rbf_s.samples).max() > 1e-10
    make(tk.SquaredExponentialKernel(), median="bisect", warm_median=True)


@pytest.mark.parametrize("kw,match", [
    (dict(kernel_impl="pallas", median="bisect"), "RBF kernel"),
    (dict(median="bisect", warm_median=True), "warm_median"),
    (dict(median="bisect", warm_median=True, step_impl="fused_gram"),
     "RBF kernel"),
    (dict(median="bisect", warm_median=True, kernel_impl="pallas",
          step_impl="epilogue"), "RBF kernel")])
def test_non_rbf_kernel_guards_match_jax(kw, match):
    """The Pallas and fused options refuse a non-RBF kernel with ValueError
    in both packages (tests/test_kernels.py:94,106)."""
    with pytest.raises(ValueError):
        sj.SVGDSampler(8, JLR(3).log_p, JLR(3).template(jnp.float32),
                       sj.Adam(), kernel=jk.InverseMultiquadricKernel(),
                       **kw)
    with pytest.raises(ValueError, match=match):
        st.SVGDSampler(8, TLR(3).log_p, TLR(3).template(), st.Adam(),
                       device="cpu", kernel=tk.InverseMultiquadricKernel(),
                       **kw)


@pytest.fixture(scope="module")
def mesh1():
    with one_process_mesh() as mesh:
        yield mesh


@pytest.mark.parametrize("comm,median", [("all_gather", "exact"),
                                         ("all_gather", "bisect"),
                                         ("ring", "bisect")])
def test_imq_sampler_on_the_mesh(mesh1, comm, median):
    """kernel= on a one-process gloo mesh (the generic tile gathered, or
    around the ring) against the single-device port sampler and the JAX
    sampler on a one-device mesh, 5 train_on_batch steps at the reference
    path's tolerance; kernel_impl='pallas' refuses the kernel."""
    jb, tb, theta0 = _lr_problem()
    kw = dict(median=median, kernel=tk.InverseMultiquadricKernel())
    meshed = st.SVGDSampler(48, TLR(6).log_p, TLR(6).template(),
                            st.Adam(1e-1), theta=theta0, device="cpu",
                            mesh=mesh1, comm=comm, **kw)
    single = st.SVGDSampler(48, TLR(6).log_p, TLR(6).template(),
                            st.Adam(1e-1), theta=theta0, device="cpu", **kw)
    js = sj.SVGDSampler(48, JLR(6).log_p, JLR(6).template(jnp.float32),
                        sj.Adam(1e-1), theta=jnp.asarray(theta0),
                        dtype=jnp.float32, median=median, comm=comm,
                        kernel=jk.InverseMultiquadricKernel(),
                        mesh=jax_mesh(jax.devices()[:1]))
    for _ in range(5):
        meshed.train_on_batch(tb)
        single.train_on_batch(tb)
        js.train_on_batch(jb)
    np.testing.assert_allclose(meshed.samples, single.samples, **REF_TOL)
    np.testing.assert_allclose(meshed.samples, np.asarray(js.samples),
                               **REF_TOL)
    with pytest.raises(ValueError, match="RBF tile"):
        st.SVGDSampler(48, TLR(6).log_p, TLR(6).template(), st.Adam(),
                       theta=theta0, device="cpu", mesh=mesh1,
                       median="bisect", kernel_impl="pallas",
                       kernel=tk.InverseMultiquadricKernel())


def test_shims_match_jax():
    """samplers, optimizers and utilities: the reference-compatible import
    paths name the port's objects, as the JAX package's name its own."""
    from stein_tpu_torch import optimizers, samplers
    assert samplers.SteinSampler is st.SVGDSampler
    assert samplers.SVGDState is st.SVGDState
    assert set(samplers.__all__) == set(jsam.__all__)
    assert set(optimizers.__all__) == set(jopt.__all__)
    assert optimizers.AdamGradientDescent is st.Adam
    assert optimizers.AdagradState is st.ops.optimizers.AdagradState
    assert set(tu.__all__) == set(ju.__all__)
    D = np.abs(np.random.default_rng(5).normal(size=(9, 9)))
    assert float(tu.compute_median(_t(D))) == float(
        ju.compute_median(jnp.asarray(D)))


def test_ravel_converters_match_jax():
    """convert_dictionary_to_array and convert_array_to_dictionary against
    JAX's: sorted keys, the same columns and access indices, the round
    trip exact."""
    rng = np.random.default_rng(6)
    d = {"w": rng.normal(size=(5, 3, 2)), "b": rng.normal(size=(5,)),
         "a": rng.normal(size=(5, 4))}
    arr, idx = tu.convert_dictionary_to_array({k: _t(v) for k, v in
                                               d.items()})
    arr_j, idx_j = ju.convert_dictionary_to_array(
        {k: jnp.asarray(v) for k, v in d.items()})
    assert idx == idx_j == {"a": (0, 4), "b": (4, 5), "w": (5, 11)}
    np.testing.assert_array_equal(arr.numpy(), np.asarray(arr_j))
    shapes = {"w": (3, 2), "b": (), "a": (4,)}
    back = tu.convert_array_to_dictionary(arr, idx, shapes)
    back_j = ju.convert_array_to_dictionary(arr_j, idx_j, shapes)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(back_j[k]))


# -------------------------------------------------------- probe_batch

def _probe_batches():
    X = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    y = X @ np.ones((4, 1), np.float32)
    yl = (X @ np.ones((4, 1)) > 0).astype(np.float32)
    return ({"X": jnp.asarray(X), "y": jnp.asarray(y)},
            {"X": _t(X), "y": _t(y)},
            {"X": jnp.asarray(X), "y": jnp.asarray(yl)},
            {"X": _t(X), "y": _t(yl)})


class _RaisingQF:
    def quadratic_form(self, batch):
        raise TypeError("needs sufficient statistics")


def _wrong_shape_qf(zeros):
    class WrongShapeQF:
        def quadratic_form(self, batch):
            return zeros((3, 3)), zeros(3), 0.0
    return WrongShapeQF()


class _WrongTypeIK:
    def inkernel_model(self, batch):
        return object()


def _wrong_grad_ik(ik, first_column):
    class WrongGradIK:
        def inkernel_model(self, batch):
            return ik(grad_fn=first_column, operands=(batch["X"],))
    return WrongGradIK()


def _flat_operand_ik(ik, grad_fn):
    class FlatOperandIK:
        def inkernel_model(self, batch):
            return ik(grad_fn=grad_fn, operands=(batch["X"].reshape(-1),))
    return FlatOperandIK()


def _bad_grads(zeros):
    class BadGrads:
        def pallas_grads(self, interpret=False):
            return lambda theta, batch: (zeros(3), theta)
    return BadGrads()


class _RaisingGrads:
    def pallas_grads(self, interpret=False):
        def hook(theta, batch):
            raise TypeError("wrong batch keys")
        return hook


# name -> ((jax model, port model), (n, p), batch kind, match)
PROBE_FAILS = {
    "qf_raises": ((_RaisingQF(), _RaisingQF()), (64, 4), "lin",
                  "quadratic_form.*raised"),
    "qf_shape": ((_wrong_shape_qf(jnp.zeros),
                  _wrong_shape_qf(torch.zeros)), (64, 4), "lin",
                 r"A_eff \[p, p\]"),
    "ik_type": ((_WrongTypeIK(), _WrongTypeIK()), (64, 4), "lin",
                "InKernelModel"),
    "ik_grad": ((_wrong_grad_ik(JIK, lambda t, X: (t[:, :1],
                                                   jnp.float32(0))),
                 _wrong_grad_ik(TIK, lambda t, X: (t[:, :1],
                                                   torch.zeros(64)))),
                (64, 4), "lin", "grad_fn must return"),
    "ik_operand": ((_flat_operand_ik(JIK, lambda t, X: (t, 0.0)),
                    _flat_operand_ik(TIK, lambda t, X: (t, t[:, 0]))),
                   (64, 4), "lin", ">=2-D"),
    "grads_shape": ((_bad_grads(jnp.zeros), _bad_grads(torch.zeros)),
                    (1000, 303), "lin", "custom_grads must return"),
    "grads_raise": ((_RaisingGrads(), _RaisingGrads()), (1000, 303), "lin",
                    "pallas_grads hook"),
}


@pytest.mark.parametrize("name", list(PROBE_FAILS))
def test_probe_batch_rejects_like_jax(name):
    """Each wrong hook raises the JAX package's ValueError at
    throughput_config time, in both packages."""
    (jmodel, tmodel), (n, p), _, match = PROBE_FAILS[name]
    jb, tb, _, _ = _probe_batches()
    with pytest.raises(ValueError, match=match):
        sj.throughput_config(n, p, model=jmodel, probe_batch=jb)
    with pytest.raises(ValueError, match=match):
        st.throughput_config(n, p, model=tmodel, probe_batch=tb)


def test_probe_batch_passes_healthy_hooks(mesh1):
    """Healthy hooks probe silently and give the unprobed config (the
    linear model's quadratic_form, the logistic model's inkernel_model,
    the NN's pallas_grads at p=303); on the mesh's fused_shard branch a
    broken quadratic_form raises and a healthy one passes; branches that
    wire no hook (large n with a quadratic_form-only model, f64) skip the
    probe, as in the JAX package."""
    _, tb, _, tbl = _probe_batches()
    lin, logreg = TLR(4), TL(4, n_train=100, n_batch=8)
    assert st.throughput_config(64, 4, model=lin, probe_batch=tb) == \
        st.throughput_config(64, 4, model=lin)
    cfg = st.throughput_config(64, 5, model=logreg, probe_batch=tbl)
    assert cfg == st.throughput_config(64, 5, model=logreg)
    nn = TNN(n_feats=1, n_hidden=100, n_train=64, n_batch=8)
    rng = np.random.default_rng(0)
    nb = {"X": _t(rng.normal(size=(8, 1)).astype(np.float32)),
          "y": _t(rng.normal(size=(8, 1)).astype(np.float32))}
    cfg = st.throughput_config(1000, 303, model=nn, probe_batch=nb)
    plain = st.throughput_config(1000, 303, model=nn)
    assert callable(cfg.pop("custom_grads")) and plain.pop("custom_grads")
    assert cfg == plain
    with pytest.raises(ValueError, match="quadratic_form.*raised"):
        st.throughput_config(64, 4, model=_RaisingQF(), probe_batch=tb,
                             mesh=mesh1)
    with pytest.raises(ValueError, match="quadratic_form.*raised"):
        sj.throughput_config(64, 4, model=_RaisingQF(),
                             probe_batch=_probe_batches()[0],
                             mesh=Mesh(np.asarray(jax.devices()[:2]),
                                       ("particles",)))
    assert st.throughput_config(64, 4, model=lin, probe_batch=tb,
                                mesh=mesh1) == \
        st.throughput_config(64, 4, model=lin, mesh=mesh1)
    st.throughput_config(65536, 512, model=_RaisingQF(), probe_batch=tb)
    st.throughput_config(64, 4, model=_RaisingQF(), probe_batch=tb,
                         dtype=torch.float64)


def test_kernels_are_top_level_exports():
    assert st.SquaredExponentialKernel is tk.SquaredExponentialKernel
    assert st.InverseMultiquadricKernel is tk.InverseMultiquadricKernel
    assert set(tk.__all__) == set(jk.__all__)
