"""The sampler's steps replayed from captured CUDA graphs.

The JAX sampler's ``run`` is ``n_steps`` steps in one device dispatch, a
``lax.scan`` over the step (``stein_tpu/api.py:1699-1729``), and so are
``train_on_batches`` and ``train_minibatched``; ``train_on_batch`` is one
jitted step. The port's counterpart on a card: ``CHUNK`` steps unrolled
into one ``torch.cuda.CUDAGraph``, captured once per sampler, entry point
and batch layout, and replayed ceil(k / CHUNK) times (a second graph of one
step takes the remainder and ``train_on_batch``). The host then makes one
launch a replay instead of every kernel of every step.

A step body is ``step(carry, batch[, operands]) -> (carry, aux)``, the
sampler's step functions. ``StepGraphs.steps`` drives k of them:

- capture: static copies of the carry (the state, and the warm median
  where there is one) and of the chunk's batch feed; one warm-up step on
  those copies outside the capture (it builds the kernel library and fills
  every cache that makes device tensors; its outputs are dropped); then
  ``steps`` steps into the graph, which writes their aux into static
  ``[steps]`` buffers and copies the last carry back into the static
  inputs as its last nodes;
- replay: the carry is copied into the static inputs once per call, each
  chunk's batch before its replay, each chunk's aux out after it; the call
  hands back fresh tensors, never the graph's buffers.

The kernel wrappers count their launches in Python, which neither a replay
nor a capture runs: StepGraphs takes the counters' delta over the capture
(``launch_counters``, the one registry of them), puts them back as they
were before the warm-up, and adds the delta at every replay, so a call
counts what the eager loop counts.

The capture itself is one injected function, ``capture(warm, body) ->
graph`` with ``graph.replay()`` and ``graph.reset()`` (``cuda_capture`` on
a card: a ``torch.cuda.CUDAGraph``), so the bookkeeping runs on the CPU
under a recorder that replays by calling ``body``.

On a mesh of more than one rank the ranks capture together: every call
first sums each graph's "capture needed" flag over the mesh (one small
collective, outside any graph), and a capture that fails on one rank
raises on every rank. A rank that captured alone would run a warm-up
step's collectives that the others never run, and the ranks would wait on
each other for ever.

A graph that captured an NCCL collective keeps a reference on the
communicator, and the communicator's finalize in
``dist.destroy_process_group()`` waits until every such graph is
destroyed (on 4 H100s it waited for ever): a process that destroys its
group calls ``release`` first, which frees every live sampler's graphs.
It also runs from ``atexit`` once a mesh has captured, so no graph
outlives its communicator when a process exits without destroying the
group (the group's destructor then aborts the communicators).

Which paths stay eager is one rule, ``eager_reason``, decided from the
sampler's configuration when it is built: only a gloo mesh, whose
collectives run on the host. Every median, ``median='binned'`` included
(its count is a kernel that reads nothing on the host), is captured.
Nothing catches a failed capture or replay to run the eager loop instead.
"""

import atexit
import dataclasses
import functools
import math
import weakref

import torch

from .profiling import annotate

# Steps unrolled into one graph.
CHUNK = 32


def tree_map(fn, tree):
    """fn on every tensor of a structure of dicts, lists, tuples and
    dataclasses (named tuples and dataclasses kept); other leaves as they
    are."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tensor_leaves(tree):
    """The tensors of a structure, in ``tree_map``'s order."""
    out = []
    tree_map(lambda l: out.append(l) or l, tree)
    return out


def _layout(tree, pointers):
    """What a capture bakes in of ``tree``: each tensor's shape, strides,
    dtype and device (and its address when ``pointers``: a graph that reads
    the tensor in place); a number, string or dataclass field by value; any
    other object (a function) by its type."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.stride(), tree.dtype, tree.device,
                tree.data_ptr() if pointers else None)
    if isinstance(tree, dict):
        return tuple((k, _layout(v, pointers)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree),) + tuple(_layout(v, pointers) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree),) + tuple(
            _layout(getattr(tree, f.name), pointers)
            for f in dataclasses.fields(tree))
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    return type(tree)


def _copy_into(dst_tree, src_tree):
    for d, s in zip(tensor_leaves(dst_tree), tensor_leaves(src_tree)):
        d.copy_(s)


def _slice_buffer(leaf, steps):
    """[steps, *leaf.shape[1:]] whose slices have the strides of leaf's,
    so a step reads its slice as the eager loop reads ``leaf[i]``."""
    inner = leaf.stride()[1:]
    span = 1 + sum((s - 1) * st for s, st in zip(leaf.shape[1:], inner))
    return torch.empty_strided((steps, *leaf.shape[1:]), (span, *inner),
                               dtype=leaf.dtype, device=leaf.device)


def mesh_ranks(mesh):
    """The number of ranks of a 1-D or 2-D mesh (1 without one)."""
    if mesh is None:
        return 1
    return (mesh.size if hasattr(mesh, "size")
            else math.prod(mesh.shape.values()))


def eager_reason(mesh):
    """THE rule of the paths a card runs eagerly, from the sampler's
    configuration: the reason, or None when the steps are captured. One
    clause: a mesh whose group is not NCCL (gloo's collectives run on the
    host, outside the card's stream).

    Every median is captured: ``median='binned'`` counts with the
    bin-count kernel (``ops/median.py:bin_count``), which reads nothing on
    the host. An NCCL mesh of any number of ranks is captured
    (``StepGraphs``: the ranks decide together when to capture; ``release``
    frees the graphs before the communicators go)."""
    if mesh is not None and mesh.device_type != "cuda":
        return "a gloo mesh: its collectives run on the host"
    return None


def launch_counters():
    """Every kernel wrapper's launch count by the kernel's name: (wrapper,
    attribute). Each wrapper adds one where it launches its kernel."""
    from ..models import bayesian_nn
    from ..ops import (
        data_product,
        fused_median,
        fused_step,
        median,
        model_grad,
        svgd_tile,
    )

    return {"B1": (fused_step.fused_warm_step_tail, "launches"),
            "B2": (fused_median.fused_warm_median_rows, "launches"),
            "B3": (svgd_tile.svgd_both_ksum, "launches"),
            "B3-bf16": (svgd_tile.svgd_both_ksum, "bf16_launches"),
            "B3-wgmma": (svgd_tile.svgd_both_ksum, "wgmma_launches"),
            "B3-wide": (svgd_tile.svgd_both_ksum, "wide_launches"),
            "B4": (fused_median.dist_block, "launches"),
            "B5": (fused_median.fused_warm_median_from_theta, "launches"),
            "B6": (fused_step.fused_epilogue, "launches"),
            "B7": (bayesian_nn.nn_grads, "launches"),
            "B8": (fused_median.fused_bracket_pass, "launches"),
            "B9": (fused_median.fused_bracket_grid_pass, "launches"),
            "B10": (svgd_tile.svgd_both_ksum_on_D, "launches"),
            "B11": (svgd_tile.svgd_phi_sym, "launches"),
            "B12": (fused_step.fused_warm_step_pblock, "launches"),
            "glm": (model_grad.glm_grads, "launches"),
            "bin_count": (median.bin_count, "launches"),
            "data_product": (data_product.data_product, "launches"),
            "data_product_t": (data_product.data_product_t, "launches"),
            "logistic": (model_grad.logistic_grads, "launches")}


def read_counts():
    return {k: getattr(*c) for k, c in launch_counters().items()}


def set_counts(counts):
    for k, c in launch_counters().items():
        setattr(*c, counts[k])


def cuda_capture(warm, body):
    """``warm()`` then a capture of ``body()`` on one side stream; returns
    the ``torch.cuda.CUDAGraph``. The capture's errors are thread-local, so
    the process group's watchdog thread does not void it."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        warm()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        body()
    torch.cuda.current_stream().wait_stream(stream)
    return graph


# Every StepGraphs of the process, held weakly (a sampler's lifetime is
# its caller's), for ``release``.
_LIVE = weakref.WeakSet()


def release():
    """Free the graphs of every live sampler, after the card's queued work.

    A graph that captured an NCCL collective holds the communicator, whose
    finalize in ``dist.destroy_process_group()`` waits until the graph is
    destroyed. Call this before destroying a mesh's process group; it runs
    from ``atexit`` once a mesh has captured. A sampler stays usable: its
    next call captures again."""
    live = [g for g in list(_LIVE) if g.graphs]
    if live and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for g in live:
        g.free()


@functools.cache
def _release_at_exit():
    """Registered once, at the first capture on a mesh: atexit runs its
    hooks last in, first out, so this runs before torch's own teardown."""
    atexit.register(release)


class _Feed:
    """A feed gives step i its batch: ``args(i)`` in the eager loop;
    ``static(steps)`` -> (j -> the args of step j of a chunk, the static
    buffers they read) in a graph, ``load`` fills those buffers once per
    call and ``fill`` before each replay."""

    def prepare(self, step):
        pass

    def load(self, buffers):
        pass

    def fill(self, buffers, start, steps):
        pass


class Fixed(_Feed):
    """``run``'s feed: one batch for every step, read in place (a graph is
    keyed by its tensors' addresses). A step with model ``operands`` (the
    fused_glm and fused_model steps) gets them built once per call; a graph
    reads them from static copies."""

    def __init__(self, batch):
        self.batch = batch
        self.ops = None

    def prepare(self, step):
        make = getattr(step, "operands", None)
        self.ops = None if make is None else make(self.batch)

    def key(self):
        return (_layout(self.batch, True), _layout(self.ops, False))

    def args(self, i):
        return (self.batch,) if self.ops is None else (self.batch, self.ops)

    def static(self, steps):
        ops = None if self.ops is None else tree_map(torch.clone, self.ops)
        return lambda j: ((self.batch,) if ops is None
                          else (self.batch, ops)), ops

    def load(self, buffers):
        if buffers is not None:
            _copy_into(buffers, self.ops)


class Slices(_Feed):
    """``train_on_batches``' feed: step i takes slice i of every leaf's
    leading axis; a graph reads the chunk's slices from a static [steps,
    ...] copy, filled before each replay."""

    def __init__(self, batches):
        self.batches = batches

    def key(self):
        return _layout(tree_map(lambda l: l[0], self.batches), False)

    def args(self, i):
        return (tree_map(lambda l: l[i], self.batches),)

    def static(self, steps):
        bufs = tree_map(lambda l: _slice_buffer(l, steps), self.batches)
        self.fill(bufs, 0, steps)
        return lambda j: (tree_map(lambda b: b[j], bufs),), bufs

    def fill(self, buffers, start, steps):
        _copy_into(buffers, tree_map(lambda l: l[start:start + steps],
                                     self.batches))


class Rows(_Feed):
    """``train_minibatched``'s feed: step i gathers rows ``idx[i]`` of the
    dataset, inside the graph from a static [steps, n_batch] copy of the
    chunk's indices (the dataset is read in place)."""

    def __init__(self, data, idx):
        self.data, self.idx = data, idx

    def key(self):
        return (_layout(self.data, True), tuple(self.idx.shape[1:]),
                self.idx.dtype)

    def args(self, i):
        return (tree_map(lambda l: l.index_select(0, self.idx[i]),
                         self.data),)

    def static(self, steps):
        idx = self.idx[:steps].clone()
        return lambda j: (tree_map(lambda l: l.index_select(0, idx[j]),
                                   self.data),), idx

    def fill(self, buffers, start, steps):
        buffers.copy_(self.idx[start:start + steps])


def eager_steps(step, carry, k, feed):
    """k steps from Python, step i on ``feed.args(i)``; the aux stacked to
    a leading [k] axis. Every carried scalar stays on the device."""
    with annotate("svgd.prep"):
        feed.prepare(step)
    auxes = []
    for i in range(k):
        carry, aux = step(carry, *feed.args(i))
        auxes.append(aux)
    return carry, {key: torch.stack([a[key] for a in auxes])
                   for key in auxes[0]}


@dataclasses.dataclass
class _Graph:
    key: tuple
    carry: object      # the static carry
    buffers: object    # the feed's static buffers
    aux: dict          # the static [steps] aux
    graph: object      # the capture's graph: replay(), reset()
    delta: list        # ((wrapper, attribute), launches) of one replay


class StepGraphs:
    """A sampler's captured graphs, one per (entry point, chunk length);
    a graph whose key (the carry's and the feed's layout) no longer
    matches is captured again, so a stale address is never replayed. On a
    ``mesh`` of more than one rank, a graph is captured again on every
    rank when it is stale on any."""

    def __init__(self, capture=cuda_capture, mesh=None, device=None):
        self.capture = capture
        self.mesh = mesh
        self.device = device    # the spans' device clock (profiling.py)
        self.graphs = {}
        self.captures = 0
        _LIVE.add(self)

    def _any_rank(self, flags):
        """Each flag or'd over the mesh's ranks: one collective, outside
        any graph (as given on one rank)."""
        if mesh_ranks(self.mesh) == 1:
            return list(flags)
        from ..parallel import collectives

        with annotate("svgd.agree"):
            flags = torch.tensor(flags, dtype=torch.int32,
                                 device=self.mesh.device)
            return [bool(f)
                    for f in collectives.psum(flags, self.mesh).tolist()]

    def _capture(self, mode, steps, step, carry, feed, key):
        self.graphs.pop((mode, steps), None)
        if self.mesh is not None:
            _release_at_exit()
        static = tree_map(torch.clone, carry)
        at, buffers = feed.static(steps)
        aux = {}
        before = read_counts()
        counts = {}

        def warm():
            _, a = step(static, *at(0))
            aux.update({k: torch.empty((steps, *v.shape), dtype=v.dtype,
                                       device=v.device)
                        for k, v in a.items()})
            counts.update(read_counts())

        def body():
            c, auxes = static, []
            for j in range(steps):
                c, a = step(c, *at(j))
                auxes.append(a)
            for k, buf in aux.items():
                torch.stack([a[k] for a in auxes], out=buf)
            _copy_into(static, c)

        failed = None
        try:
            graph = self.capture(warm, body)
        except Exception as err:   # told to the other ranks, then raised
            failed = err
        if self._any_rank([failed is not None])[0]:
            set_counts(before)
            if failed is not None:
                raise failed
            raise RuntimeError(f"the capture of the {mode!r} graph failed "
                               "on another rank of the mesh")
        after = read_counts()
        set_counts(before)
        registry = launch_counters()
        g = _Graph(key, static, buffers, aux, graph,
                   [(registry[k], after[k] - counts[k]) for k in after
                    if after[k] != counts[k]])
        self.graphs[(mode, steps)] = g
        self.captures += 1
        return g

    def free(self):
        """Destroy every graph (the next call captures again)."""
        for g in self.graphs.values():
            g.graph.reset()
        self.graphs.clear()

    def _ready(self, mode, steps, new, step, carry, feed, layout):
        """The (mode, steps) graph, captured when ``new``, its static carry
        and feed buffers loaded from ``carry`` and ``feed``."""
        if new:
            with annotate("svgd.capture"):
                g = self._capture(mode, steps, step, carry, feed, layout)
        else:
            g = self.graphs[(mode, steps)]
        _copy_into(g.carry, carry)
        feed.load(g.buffers)
        return g

    def steps(self, mode, step, carry, k, feed):
        """k steps of ``step`` from ``carry`` on ``feed``: CHUNK-step
        replays, then one-step replays for the remainder. Returns (the new
        carry as fresh tensors, the aux with a leading [k] axis). Spans:
        ``svgd.prep`` up to the first replay, then ``svgd.replays``."""
        with annotate("svgd.prep", self.device):
            feed.prepare(step)
            full, rest = divmod(k, CHUNK)
            plan = [(steps, count)
                    for steps, count in ((CHUNK, full), (1, rest)) if count]
            layout = (_layout(carry, False), feed.key())
            stale = self._any_rank([
                getattr(self.graphs.get((mode, steps)), "key", None) != layout
                for steps, _ in plan])
            g = self._ready(mode, plan[0][0], stale[0], step, carry, feed,
                            layout)
            out = {key: torch.empty((k, *b.shape[1:]), dtype=b.dtype,
                                    device=b.device)
                   for key, b in g.aux.items()}
        with annotate("svgd.replays", self.device):
            start = 0
            for i, ((steps, count), new) in enumerate(zip(plan, stale)):
                if i:
                    g = self._ready(mode, steps, new, step, carry, feed,
                                    layout)
                for _ in range(count):
                    feed.fill(g.buffers, start, steps)
                    with annotate("svgd.launch"):
                        g.graph.replay()
                    for (wrapper, attr), d in g.delta:
                        setattr(wrapper, attr, getattr(wrapper, attr) + d)
                    for key, b in g.aux.items():
                        out[key][start:start + steps].copy_(b)
                    start += steps
                carry = g.carry
            return tree_map(torch.clone, carry), out
