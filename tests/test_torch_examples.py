"""The example CLIs of the port (examples_torch/) on the CPU, as
tests/test_examples.py runs the JAX package's (examples/): tiny configs
with --device cpu, asserting the same printed numbers at the same bounds.
Their data helpers (generate_data, load_csv_data, load_covertype) return
arrays equal to the JAX examples' on the same seed and file, and without a
card the CLIs' default --device cuda raises."""

import importlib.util
import re
import runpy
import sys

import numpy as np
import pytest


def _run(script, args, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [script] + args + ["--device", "cpu"])
    runpy.run_path(script, run_name="__main__")
    return capsys.readouterr().out


def _floats(line):
    return [float(t) for t in
            re.findall(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?", line)]


def _line(out, prefix):
    hits = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    assert hits, f"no line starting with {prefix!r} in:\n{out}"
    return hits[-1]


def _module(path, name):
    """A CLI's module, imported under its own name (the two packages'
    examples share file names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_linear_regression_converges(capsys, monkeypatch):
    """Posterior-mean coefficients reach the conjugate closed form
    (linear_regression/main.py:51-53)."""
    out = _run("examples_torch/linear_regression.py", ["--n-iters", "400"],
               capsys, monkeypatch)
    est = _floats(_line(out, "Est. coefficients:"))
    conj = _floats(_line(out, "Conjugate posterior mean:"))
    assert len(est) == len(conj) >= 1
    np.testing.assert_allclose(est, conj, atol=5e-2)


def test_linear_regression_plot(capsys, monkeypatch, tmp_path):
    pytest.importorskip("matplotlib")
    plot = str(tmp_path / "linreg.png")
    out = _run("examples_torch/linear_regression.py",
               ["--n-iters", "60", "--plot", plot], capsys, monkeypatch)
    assert f"Saved figure to {plot}" in out
    assert (tmp_path / "linreg.png").stat().st_size > 0


def test_linear_regression_sufficient_stats_converges(capsys, monkeypatch):
    out = _run("examples_torch/linear_regression.py",
               ["--n-iters", "400", "--sufficient-stats"],
               capsys, monkeypatch)
    est = _floats(_line(out, "Est. coefficients"))
    post = _floats(_line(out, "Conjugate posterior mean"))
    np.testing.assert_allclose(est, post, atol=0.15)


@pytest.mark.parametrize("extra", [[], ["--on-device-sampling"],
                                   ["--step-impl", "fused_model"]],
                         ids=["host-indices", "on-device", "fused_model"])
def test_logistic_regression_accuracy_climbs(extra, capsys, monkeypatch):
    """Held-out accuracy of the particle-averaged logits rises well above
    chance (logistic_regression/main.py:52-61)."""
    out = _run(
        "examples_torch/logistic_regression.py",
        ["--n-iters", "40", "--n-particles", "8", "--n-prog", "20",
         "--n-data", "500", *extra], capsys, monkeypatch)
    first = _floats(_line(out, "Iteration 0 /"))[-1]
    final = _floats(_line(out, "Final accuracy:"))[0]
    assert final >= 0.70, f"final accuracy {final} (started {first})"
    assert final > first


@pytest.mark.parametrize("tuned", [False, True], ids=["default", "tuned"])
def test_regression_neural_network_mse_falls(tuned, capsys, monkeypatch):
    """The MSE falls (and with --tuned, throughput_config's fused_gram tail
    at this tiny shape learns the same)."""
    out = _run(
        "examples_torch/regression_neural_network.py",
        ["--n-iters", "200", "--n-particles", "4", "--n-hidden", "8",
         "--n-prog", "100"] + (["--tuned"] if tuned else []),
        capsys, monkeypatch)
    first = _floats(_line(out, "Iteration: 0."))[-1]
    final = _floats(_line(out, "Final MSE:"))[0]
    assert np.isfinite(final)
    assert final < first - 0.05, f"MSE {first} -> {final}: did not learn"
    if not tuned:
        assert final < 4.7


def test_production_run_recovers_and_reports(capsys, monkeypatch, tmp_path):
    """Checkpoints every 20 steps, reports accuracy and KSD; run again with
    a larger --n-iters it resumes from the checkpoint and executes only the
    rest."""
    args = ["--n-particles", "8", "--n-batch", "16", "--ckpt-every", "20",
            "--ckpt", str(tmp_path / "prod.ckpt")]
    out = _run("examples_torch/production_run.py", ["--n-iters", "40"] + args,
               capsys, monkeypatch)
    accs = [_floats(ln.split("held-out acc")[1])[0]
            for ln in out.splitlines() if "held-out acc" in ln]
    assert accs and all(0.0 <= a <= 1.0 for a in accs)
    ksd = _floats(_line(out, "final KSD^2:"))[-1]   # [-1]: "KSD^2" parses a 2
    assert np.isfinite(ksd) and ksd > 0
    assert "executed 40 steps" in out
    out = _run("examples_torch/production_run.py",
               ["--n-iters", "60", "--mesh"] + args, capsys, monkeypatch)
    assert "executed 20 steps" in out and "total step count 60" in out


@pytest.mark.parametrize("extra,banner", [
    (["--kernel-impl", "xla"], "[xla/bisect]"),
    (["--kernel-impl", "xla", "--mesh"], "[xla/bisect/mesh1]"),
    (["--median", "binned"], "[pallas/binned]"),
    (["--median", "subsample"], "[pallas/subsample]"),
    (["--mesh", "--median", "binned"], "[pallas/binned/mesh1]"),
], ids=["xla", "xla-mesh", "binned", "subsample", "binned-mesh"])
def test_large_particle_posterior_and_throughput(extra, banner, capsys,
                                                 monkeypatch):
    """The throughput line names the configuration (and the mesh), and the
    posterior check passes (64 particles, 301 iterations: the JAX test's
    band, measured there 0.07 with MC error scale 0.02)."""
    out = _run(
        "examples_torch/large_particle.py",
        ["--n-particles", "64", "--n-feats", "4", "--n-obs", "50",
         "--n-iters", "301", "--chunk", "50", *extra], capsys, monkeypatch)
    line = _line(out, "250 steps")
    assert _floats(line.split("->")[1])[0] > 0 and banner in line
    err_line = _line(out, "posterior mean max-abs-err")
    assert _floats(err_line)[0] < 0.2, err_line


def test_gaussian_mixture_captures_all_modes(capsys, monkeypatch):
    """Particles populate all modes with roughly the right mass (a
    collapse would put ~1.0 on one mode)."""
    out = _run(
        "examples_torch/gaussian_mixture.py",
        ["--n-particles", "120", "--n-iters", "1500"], capsys, monkeypatch)
    masses = []
    for ln in out.splitlines():
        if ln.startswith("mode "):
            nums = _floats(ln)
            true_w, mass, mean_err = nums[1], nums[2], nums[3]
            masses.append((true_w, mass))
            assert abs(mass - true_w) < 0.15, ln
            assert mean_err < 0.15, ln
    assert len(masses) == 3
    ksd = _floats(_line(out, "KSD^2:"))[-1]   # [-1]: "KSD^2" parses a 2
    assert 0 < ksd < 0.1


def test_load_csv_data_reads_reference_layout(tmp_path):
    """load_csv_data reads the reference's CSV layout (np.savetxt,
    comma-delimited, one column) as the JAX example's does."""
    rng = np.random.default_rng(3)
    n, k = 40, 1
    X = rng.normal(size=(n, k))
    w = rng.normal(size=(k, 1)) * 5
    y = rng.normal(X @ w, 0.3)
    np.savetxt(tmp_path / "data_X.csv", X, delimiter=",")
    np.savetxt(tmp_path / "data_w.csv", w, delimiter=",")
    np.savetxt(tmp_path / "data_y.csv", y, delimiter=",")
    port = _module("examples_torch/linear_regression.py", "t_linreg")
    lx, lw, ly = port.load_csv_data(str(tmp_path))
    np.testing.assert_allclose(lx, X)
    np.testing.assert_allclose(lw, w)
    np.testing.assert_allclose(ly, y)
    assert lx.shape == (n, k) and lw.shape == (k, 1) and ly.shape == (n, 1)
    jax_ex = _module("examples/linear_regression.py", "j_linreg")
    for a, b in zip(port.load_csv_data(str(tmp_path)),
                    jax_ex.load_csv_data(str(tmp_path))):
        np.testing.assert_array_equal(a, b)


def _covertype_file(tmp_path, n, k, seed, separable=False):
    scipy_io = pytest.importorskip("scipy.io")
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, k))
    if separable:
        w = rng.normal(size=(k, 1))
        labels = np.where(feats @ w + rng.normal(size=(n, 1)) * 0.3 > 0,
                          1.0, 2.0)   # Covertype's classes {1, 2}
    else:
        labels = rng.choice([1.0, 2.0], size=(n, 1))
    path = str(tmp_path / "covertype.mat")
    scipy_io.savemat(path, {"covtype": np.concatenate([labels, feats], 1)})
    return path, feats, labels


def test_load_covertype_semantics(tmp_path):
    """Column 0 is the label with class 2 relabelled to 0, the rest are
    features (logistic_regression/main.py:11-13); the JAX example's
    arrays."""
    path, feats, labels = _covertype_file(tmp_path, 30, 5, 4)
    port = _module("examples_torch/logistic_regression.py", "t_logreg")
    X, y = port.load_covertype(path)
    np.testing.assert_allclose(X, feats)
    np.testing.assert_allclose(y, np.where(labels == 2.0, 0.0, 1.0))
    assert set(np.unique(y)) <= {0.0, 1.0}
    jX, jy = _module("examples/logistic_regression.py",
                     "j_logreg").load_covertype(path)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)


def test_logistic_regression_with_mat_file(capsys, monkeypatch, tmp_path):
    """The --data branch on a user-supplied .mat file learns."""
    path, _, _ = _covertype_file(tmp_path, 400, 8, 5, separable=True)
    out = _run(
        "examples_torch/logistic_regression.py",
        ["--n-iters", "40", "--n-particles", "8", "--n-prog", "20",
         "--data", path], capsys, monkeypatch)
    assert _floats(_line(out, "Final accuracy:"))[0] >= 0.70, out


@pytest.mark.parametrize("name,kw", [
    ("linear_regression", {}), ("linear_regression", dict(seed=3, n=50,
                                                          k=4)),
    ("logistic_regression", {}), ("logistic_regression",
                                  dict(seed=2, n=300, n_feats=7)),
    ("regression_neural_network", {}),
    ("regression_neural_network", dict(seed=5, n=33)),
])
def test_generate_data_matches_jax_examples(name, kw):
    """generate_data returns the JAX example's arrays on the same seed."""
    port = _module(f"examples_torch/{name}.py", f"t_{name}")
    jax_ex = _module(f"examples/{name}.py", f"j_{name}")
    got, want = port.generate_data(**kw), jax_ex.generate_data(**kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", [
    "linear_regression", "logistic_regression", "regression_neural_network",
    "gaussian_mixture", "production_run", "large_particle"])
def test_default_device_without_card_raises(name, monkeypatch):
    """--device defaults to cuda and raises without a card (no fallback to
    the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_path(f"examples_torch/{name}.py", run_name="__main__")
