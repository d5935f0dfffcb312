"""The port's public signatures against the JAX package's, and its
NotImplementedError messages against ROADMAP.md.

Signatures: every parameter of a JAX entry point that the port has must be
a parameter of the port's counterpart, in the same order, with the same
default where the JAX default is a plain value (a number, string, bool or
None; a dtype default is compared by its name). The port may add
parameters (``device=``). The one rename is JAX's ``key`` (a PRNG key),
which is the port's ``generator`` (a torch.Generator) where the port has no
``key`` of its own (``train_minibatched`` keeps ``key``: an int seed or a
torch.Generator). One default differs on purpose (``OWN_DEFAULTS``):
``enable_compilation_cache``'s ``path`` is the port's build root beside the
package, where the JAX package's XLA cache sits in ``/tmp``.

Messages: every ``_unported(what, item)`` in the port names an item of
ROADMAP.md's queue A that exists and mentions the option, so that a
renumbering of the queue cannot leave a message pointing at the wrong
item; since queue A's modules are all ported, none is left.

Public names: every name in ``__all__`` of ``stein_tpu``, ``stein_tpu.ops``,
``stein_tpu.parallel``, ``stein_tpu.models`` and ``stein_tpu.utils`` exists
in the port's matching module."""

import ast
import inspect
import pathlib
import re

import pytest
import torch

import stein_tpu as sj
import stein_tpu_torch as st
from stein_tpu import kernels as jk
from stein_tpu import models as jm
from stein_tpu.ops import diagnostics as jd
from stein_tpu.ops import pallas_step as jstep
from stein_tpu.ops import rbf as jrbf
from stein_tpu.utils import cache as jcache
from stein_tpu.utils import checkpoint as jc
from stein_tpu.utils import hostio as jh
from stein_tpu.utils import metrics as jmet
from stein_tpu.utils import profiling as jprof
from stein_tpu.utils import ravel as jr
from stein_tpu.utils import recovery as jrec
from stein_tpu_torch import kernels as tk
from stein_tpu_torch import models as tm
from stein_tpu_torch.ops import diagnostics as td
from stein_tpu_torch.ops import fused_step as tstep
from stein_tpu_torch.ops import rbf as trbf
from stein_tpu_torch.utils import cache as tcache
from stein_tpu_torch.utils import checkpoint as tc
from stein_tpu_torch.utils import hostio as th
from stein_tpu_torch.utils import metrics as tmet
from stein_tpu_torch.utils import profiling as tprof
from stein_tpu_torch.utils import ravel as tr
from stein_tpu_torch.utils import recovery as trec

ROOT = pathlib.Path(__file__).resolve().parent.parent
RENAMES = {"key": "generator"}
OWN_DEFAULTS = {("enable_compilation_cache", "path")}

ENTRY_POINTS = [
    (sj.SVGDSampler, st.SVGDSampler),
    (sj.throughput_config, st.throughput_config),
    (sj.Adam, st.Adam),
    (sj.Adagrad, st.Adagrad),
    (sj.AdamGradientDescent, st.AdamGradientDescent),
    (sj.AdagradGradientDescent, st.AdagradGradientDescent),
    (jr.template_unraveler, tr.template_unraveler),
    (jr.ravel_particles, tr.ravel_particles),
    (jr.unravel_particles, tr.unravel_particles),
    (jr.init_particles, tr.init_particles),
    (jm.BayesianNNModel, tm.BayesianNNModel),
    (jm.LinearRegressionModel, tm.LinearRegressionModel),
    (jm.LogisticRegressionModel, tm.LogisticRegressionModel),
    (jstep.InKernelModel, tstep.InKernelModel),
    (jr.convert_dictionary_to_array, tr.convert_dictionary_to_array),
    (jr.convert_array_to_dictionary, tr.convert_array_to_dictionary),
    (jrbf.rbf_kernel_and_repulse, trbf.rbf_kernel_and_repulse),
    (jd.ksd_rbf, td.ksd_rbf),
    (jk.SquaredExponentialKernel, tk.SquaredExponentialKernel),
    (jk.InverseMultiquadricKernel, tk.InverseMultiquadricKernel),
    (jk.generic_svgd_phi, tk.generic_svgd_phi),
    (jk.SquaredExponentialKernel.kernel_and_grad,
     tk.SquaredExponentialKernel.kernel_and_grad),
    (jk.InverseMultiquadricKernel.kernel_and_grad,
     tk.InverseMultiquadricKernel.kernel_and_grad),
    (jc.save_checkpoint, tc.save_checkpoint),
    (jc.restore_checkpoint, tc.restore_checkpoint),
    (jrec.train_with_recovery, trec.train_with_recovery),
    (jmet.MetricsLogger, tmet.MetricsLogger),
    (jmet.MetricsLogger.record, tmet.MetricsLogger.record),
    (jh.host_array, th.host_array),
    (jh.host_scalar, th.host_scalar),
    (jprof.trace, tprof.trace),
    (jprof.annotate, tprof.annotate),
    (jcache.enable_compilation_cache, tcache.enable_compilation_cache),
] + [(getattr(sj.SVGDSampler, name), getattr(st.SVGDSampler, name))
     for name in ("run", "train_on_batch", "train_on_batches",
                  "train_minibatched", "function_posterior", "ksd", "save",
                  "restore")]


def _default(value):
    if value is inspect.Parameter.empty or value is None or isinstance(
            value, (bool, int, float, str)):
        return value
    return getattr(value, "__name__", str(value)).split(".")[-1]


@pytest.mark.parametrize("jax_fn,port_fn", ENTRY_POINTS,
                         ids=[j.__qualname__ for j, _ in ENTRY_POINTS])
def test_port_signature_takes_every_jax_parameter(jax_fn, port_fn):
    jp = inspect.signature(jax_fn).parameters
    tp = inspect.signature(port_fn).parameters
    renames = {k: v for k, v in RENAMES.items() if k not in tp}
    names = [renames.get(n, n) for n in jp]
    missing = [n for n in names if n not in tp]
    assert not missing, f"{port_fn.__name__} lacks {missing}"
    order = list(tp)
    assert [order.index(n) for n in names] == sorted(
        order.index(n) for n in names), f"{port_fn.__name__}: order"
    for name, param in jp.items():
        if param.default is inspect.Parameter.empty or (
                port_fn.__name__, name) in OWN_DEFAULTS:
            continue
        got = tp[renames.get(name, name)].default
        assert _default(got) == _default(param.default), (
            f"{port_fn.__name__}({name}=): {got!r} vs JAX {param.default!r}")


def test_top_level_exports_cover_the_jax_package():
    """Every name the JAX package exports (the kernels/ module's two
    kernels included since ROADMAP A3 was ported)."""
    assert set(sj.__all__) <= set(st.__all__)
    for name in st.__all__:
        assert hasattr(st, name)


def _queue_a():
    """{number: text} of ROADMAP.md's queue A items."""
    text = (ROOT / "ROADMAP.md").read_text()
    section = text.split("### A.", 1)[1].split("\n### ", 1)[0]
    items = re.split(r"\n(?=\d+\. )", section)
    return {int(m.group(1)): body for body in items
            if (m := re.match(r"(\d+)\. ", body))}


def _unported_calls():
    """(file:line, the message's literal text, item) of every _unported
    call in the port (an f-string contributes its literal parts)."""
    calls = []
    for path in sorted((ROOT / "stein_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "_unported"):
                continue
            what, item = node.args
            parts = what.values if isinstance(what, ast.JoinedStr) else [what]
            text = "".join(p.value for p in parts
                           if isinstance(p, ast.Constant))
            calls.append((f"{path.name}:{node.lineno}", text, item.value))
    return calls


# Words of the messages that name no option.
_GENERIC = {"SVGDSampler", "throughput_config", "the", "D", "particles", "x",
            "model", "mesh", "True", "and", "settings"}


def test_unported_messages_name_their_roadmap_item():
    items = _queue_a()
    calls = _unported_calls()
    # Items A2-A7 are ported: no option of the JAX package is left that
    # the port refuses.
    assert calls == []
    for where, text, item in calls:
        number = int(item.lstrip("A"))
        assert item == f"A{number}" and number in items, (where, item)
        words = set(re.findall(r"[A-Za-z_]+", text)) - _GENERIC
        assert words, (where, text)
        for word in words:
            assert word in items[number], (
                f"{where}: ROADMAP.md queue A item {number} does not "
                f"mention {word!r} ({text!r})")


@pytest.mark.parametrize("kw", [dict(binned_bins=2048),
                                dict(binned_block_rows=64)])
def test_binned_settings_name_the_medians_item(kw, monkeypatch):
    """median='binned''s settings (ROADMAP A5, ported): a sampler with a
    non-default binned_bins or binned_block_rows hands them to
    binned_median's histogram, and its first median is binned_median's
    with them."""
    from stein_tpu_torch.ops import median as tmed

    seen = []
    hist = tmed._block_histogram
    monkeypatch.setattr(tmed, "_block_histogram", lambda *a: (
        seen.append(a[-2:]), hist(*a))[1])
    model = tm.LinearRegressionModel(3)
    theta = torch.randn(40, 3, generator=torch.Generator().manual_seed(0))
    s = st.SVGDSampler(40, model.log_p, model.template(), st.Adam(),
                       theta=theta, device="cpu", median="binned", **kw)
    batch = {"X": torch.ones(5, 3), "y": torch.ones(5, 1)}
    med = s.train_on_batch(batch)["median"]
    settings = (kw.get("binned_bins", 4096), kw.get("binned_block_rows", 256))
    assert seen and set(seen) == {settings}
    assert med == tmed.binned_median(theta, n_bins=settings[0],
                                     block_rows=settings[1])


@pytest.mark.parametrize("module", ["", ".ops", ".parallel", ".models",
                                    ".utils"])
def test_public_names_cover_the_jax_package(module):
    """Every name the JAX module exports exists in the port's counterpart
    (``from stein_tpu_torch.parallel import make_sharded_step`` works
    where ``from stein_tpu.parallel import make_sharded_step`` does)."""
    import importlib

    jmod = importlib.import_module("stein_tpu" + module)
    tmod = importlib.import_module("stein_tpu_torch" + module)
    missing = [n for n in jmod.__all__ if not hasattr(tmod, n)]
    assert not missing, f"stein_tpu_torch{module} lacks {missing}"
    assert set(jmod.__all__) <= set(tmod.__all__)


def test_jax_keywords_are_accepted():
    """donate=, pallas_interpret=, throughput_config(pallas_interpret=),
    template_unraveler(dtype=) and the models' precision= are accepted and
    change nothing; an unknown model precision raises as JAX's
    resolve_precision would."""
    model = tm.LinearRegressionModel(3, precision="default")
    cfg = st.throughput_config(64, 3, pallas_interpret=True)
    assert cfg == st.throughput_config(64, 3)
    s = st.SVGDSampler(8, model.log_p, model.template(), st.Adam(),
                       device="cpu", donate=False, pallas_interpret=True)
    assert s.n_params == 3
    n, unravel = tr.template_unraveler(model.template(), dtype=torch.float64)
    assert n == 3 and unravel(torch.zeros(3))["w"].shape == (3, 1)
    assert tm.BayesianNNModel(1, 4, 8, 8, precision="highest").n_hidden == 4
    with pytest.raises(ValueError, match="precision"):
        tm.LogisticRegressionModel(3, 10, 5, precision="fast")
