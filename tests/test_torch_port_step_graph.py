"""Phases 1-2 and phases 3-5 of the train step from CUDA graphs
(``pointcloududa_torch/train/step_graph.py``), held on the CPU with the
capture mocked: when the step engages a graph and when it runs a block
eagerly, what a graph is keyed by, the guard that asks for a new capture, and
a stand-in for the graph that runs the captured block again at each replay,
through which K steps equal K eager steps bit for bit (the inputs copied in,
the metrics copied out, the gradients pointed back, the keys and the cache;
the generator's update eager between the two blocks). A real graph against
eager steps is held on the card, in ``test_torch_port_cuda.py``. Imports no
JAX."""

import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pointcloududa_torch.config import mmwhs_default, mscmrseg_default
from pointcloududa_torch.data.synthetic import synthetic_batch
from pointcloududa_torch.train import step_graph
from pointcloududa_torch.train.state import create_train_state, set_generator_lr
from pointcloududa_torch.train.step import make_train_step
from pointcloududa_torch.utils import timer

SMALL = dict(filters=4, crop_size=32, n_block=2, fc_inch=9, bs=2)
# the two paper configurations' discriminators at a small size
CONFIGS = {
    "mscmrseg": lambda **kw: mscmrseg_default(d1=True, d2=True, d4=True, **SMALL, **kw),
    "mmwhs": lambda **kw: mmwhs_default(d1=True, d2=True, d4=True, ft=True, extd4=True, softmax=True, d1_on_probs=True,
                                        entropy_norm=True, **SMALL, **kw),
}
D_SPANS = [f"uda.step.d{k}.{part}" for k in (1, 2, 4) for part in ("forward", "backward", "update")]
BLOCKS = ("gen", "disc")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs (the test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StandIn:
    """A CUDA graph's stand-in on the CPU. A capture runs nothing on a
    device, and the step replays at once; here the capture runs the block
    (the two together one execution), and each later replay runs it again and
    writes its metrics into the captured output, as a replay rewrites it.
    ``pool``: the pool given (``None``: one of its own)."""

    def __init__(self, body, generator, pool=None):
        self.body, self.out, self.fresh = body, body(), True
        self.pool = pool if pool is not None else object()

    def replay(self):
        if not self.fresh:
            self.out.copy_(self.body())
        self.fresh = False
        return self.out


def _batches(cfg, n, tail_at=(), without_vert_t=()):
    out = []
    for s in range(n):
        b = synthetic_batch(cfg, cfg.bs, seed=s)
        if s in tail_at:
            b["sample_mask"] = np.array([1] + [0] * (cfg.bs - 1), np.float32)
        if s in without_vert_t:  # an off-cadence step (vert_t_every > 1)
            del b["vert_t"]
        out.append(b)
    return out


def _run(cfg, batches, graphed=(), hook=None, make_graph=StandIn):
    """K steps from one seed; ``graphed``: the blocks (``"gen"``,
    ``"disc"``) that take the card's route with ``make_graph`` in place of a
    CUDA graph. Returns the state, each step's metrics, the number of
    captures of each block, the span totals and the step."""
    st = create_train_state(cfg, seed=3, device="cpu")
    step = make_train_step(cfg, st.models, st.optimizers)
    captures = {block: 0 for block in BLOCKS}
    for block in graphed:
        graphs = getattr(step, f"{block}_graphs")
        graphs.on_card = True

        def counted(body, gen, pool, block=block):
            captures[block] += 1
            return make_graph(body, gen, pool)

        graphs.make_graph = counted
    timer.reset_spans()
    metrics = []
    for i, b in enumerate(batches):
        if hook is not None:
            hook(i, st)
        st, m = step(st, b)
        metrics.append(m)
    return st, metrics, captures, timer.span_totals(), step


def _calls(totals, name):
    return totals.get(name, (0, 0))[1]


def _assert_same(a, b):
    """Two runs' states and metrics bit for bit: every network's parameters
    and buffers, every optimiser's state, the dropout generator, each step's
    metrics."""
    (sa, ma), (sb, mb) = a, b
    for na, nb in zip(sa.models, sb.models):
        if na is not None:
            for (k, va), (_, vb) in zip(na.state_dict().items(), nb.state_dict().items()):
                assert torch.equal(va, vb), k
    for oa, ob in zip(sa.optimizers, sb.optimizers):
        if oa is not None:
            assert len(oa.state) == len(ob.state)
            for pa, pb in zip(oa.state.values(), ob.state.values()):
                for k in pa:
                    assert torch.equal(torch.as_tensor(pa[k]), torch.as_tensor(pb[k])), k
    assert torch.equal(sa.generator.get_state(), sb.generator.get_state())
    assert len(ma) == len(mb)
    for i, (x, y) in enumerate(zip(ma, mb)):
        assert list(x) == list(y)
        for k in x:
            assert torch.equal(x[k], y[k]), (i, k)


def _refuse(body, gen, pool):
    raise AssertionError("captured where the step should run its blocks eagerly")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stand_in_graph_steps_equal_eager_steps(name):
    """Six steps: the first runs eagerly (the warm-up), the second captures
    and replays, the rest replay; all bit-equal to six eager steps, each
    step's metrics a tensor of its own."""
    cfg = CONFIGS[name]()
    batches = _batches(cfg, 6)
    eager = _run(cfg, batches)
    graphed = _run(cfg, batches, graphed=("disc",))
    _assert_same(eager[:2], graphed[:2])
    assert graphed[2] == {"gen": 0, "disc": 1}
    totals = graphed[3]
    assert _calls(totals, timer.DISC_CAPTURE) == 1 and _calls(totals, timer.DISC_REPLAY) == 5
    assert eager[2] == {"gen": 0, "disc": 0} and _calls(eager[3], timer.DISC_REPLAY) == 0
    storages = {m["d4_loss"].untyped_storage().data_ptr() for m in graphed[1]}
    assert len(storages) == 6


@pytest.mark.parametrize("name", sorted(CONFIGS) + ["mscmrseg-sgd"])
def test_stand_in_generator_graph_steps_equal_eager_steps(name):
    """Six steps with both blocks graphed (phases 1-2 and 3-5, the
    generator's update eager between them): the first eager, the second
    captures each block, the rest replay; bit-equal to six eager steps in
    parameters, BatchNorm running statistics, every optimiser's state (Adam's
    moments; under ``-sgd`` the momentum, the unused ``conv1_1`` decayed
    too), the dropout generator and each step's metrics."""
    cfg = CONFIGS[name.split("-")[0]](sgd=name.endswith("sgd"))
    batches = _batches(cfg, 6)
    eager = _run(cfg, batches)
    graphed = _run(cfg, batches, graphed=BLOCKS)
    _assert_same(eager[:2], graphed[:2])
    assert graphed[2] == {"gen": 1, "disc": 1}
    totals = graphed[3]
    assert _calls(totals, timer.GEN_CAPTURE) == 1 and _calls(totals, timer.GEN_REPLAY) == 5
    assert _calls(totals, timer.DISC_CAPTURE) == 1 and _calls(totals, timer.DISC_REPLAY) == 5
    assert _calls(eager[3], timer.GEN_REPLAY) == 0 and _calls(eager[3], timer.GEN_CAPTURE) == 0
    storages = {m["seg_loss"].untyped_storage().data_ptr() for m in graphed[1]}
    assert len(storages) == 6


@pytest.mark.parametrize("case", ["cpu", "mesh", "anomaly", "key_seen_once"])
def test_eager_where_the_graph_does_not_engage(case, monkeypatch):
    """On a CPU device, under a data mesh, in anomaly mode, and for inputs
    or hyper-parameters seen once, both blocks run eagerly: today's results
    bit for bit, the generator's and the discriminators' spans fire every
    step and no replay."""
    cfg = CONFIGS["mmwhs"]()
    tail_at, hook = (), None
    if case == "key_seen_once":  # a full batch, a padded tail, then D1 at another lr
        tail_at = (1,)

        def hook(i, st):
            if i == 2:
                st.optimizers[1].param_groups[0]["lr"] *= 0.5

    batches = _batches(cfg, 3, tail_at)
    if case == "key_seen_once":  # and phases 1-2 see a tail, then a full batch without vert_t
        del batches[2]["vert_t"]
    want = _run(cfg, batches, hook=hook)
    if case == "mesh":
        monkeypatch.setattr(step_graph, "collectives", SimpleNamespace(active=lambda: True))
    with torch.autograd.set_detect_anomaly(case == "anomaly"):
        got = _run(cfg, batches, graphed=BLOCKS if case != "cpu" else (), hook=hook, make_graph=_refuse)
    _assert_same(want[:2], got[:2])
    assert got[2] == {"gen": 0, "disc": 0}
    assert not any(_calls(got[3], span) for span in timer.DISC_GRAPH + timer.GEN_GRAPH)
    assert all(_calls(got[3], span) == 3 * (2 if span.endswith("update") else 1) for span in D_SPANS)
    assert _calls(got[3], "uda.step.gen_forward") == 3 and _calls(got[3], "uda.step.gen_backward") == 3


def test_the_key_follows_the_inputs_and_the_hyper_parameters():
    """A graph holds its inputs' shapes and dtypes and the optimisers'
    hyper-parameters as constants: a change of any is another key."""
    cfg = CONFIGS["mscmrseg"]()
    st = create_train_state(cfg, seed=0, device="cpu")
    opts = [o for o in st.optimizers[1:] if o is not None]
    x = {"d1_src": torch.zeros(2, 8, 8, 4), "d1_tgt": torch.zeros(2, 8, 8, 4)}
    key = step_graph.graph_key(x, opts)
    assert step_graph.graph_key({k: v.clone() for k, v in x.items()}, opts) == key
    others = [
        {**x, "sample_mask": torch.ones(2)},
        {**x, "d1_tgt": torch.zeros(2, 8, 8, 5)},
        {**x, "d1_tgt": torch.zeros(2, 8, 8, 4, dtype=torch.bfloat16)},
    ]
    assert all(step_graph.graph_key(o, opts) != key for o in others)
    for field, value in (("lr", 1e-3), ("momentum", 0.5), ("weight_decay", 0.0)):
        before = opts[0].param_groups[0][field]
        opts[0].param_groups[0][field] = value
        assert step_graph.graph_key(x, opts) != key, field
        opts[0].param_groups[0][field] = before
    assert step_graph.graph_key(x, opts) == key


def test_the_generator_key_follows_the_batch_names_shapes_and_dtypes():
    """Phases 1-2 are keyed by the batch alone: ``vert_t`` (present on the
    cadence's steps only) and a tail's ``sample_mask`` are other keys, as is
    another shape or dtype; the generator's optimiser is no part of it."""
    cfg = CONFIGS["mscmrseg"]()
    st = create_train_state(cfg, seed=0, device="cpu")
    b = {k: torch.as_tensor(v) for k, v in synthetic_batch(cfg, cfg.bs, seed=0).items()}
    key = step_graph.graph_key(b, ())
    assert step_graph.graph_key({k: v.clone() + 1 for k, v in b.items()}, ()) == key
    off_cadence = {k: v for k, v in b.items() if k != "vert_t"}
    others = [
        off_cadence,
        {**b, "sample_mask": torch.ones(cfg.bs)},
        {**off_cadence, "sample_mask": torch.ones(cfg.bs)},
        {**b, "img_t": torch.zeros(cfg.bs, 16, 16, 3)},
        {**b, "img_s": b["img_s"].to(torch.bfloat16)},
    ]
    keys = [step_graph.graph_key(o, ()) for o in others]
    assert len(set(keys) | {key}) == len(others) + 1
    step = make_train_step(cfg, st.models, st.optimizers)
    set_generator_lr(st, 1e-5)
    assert step_graph.graph_key(b, step.gen_graphs._opts) == key


def test_the_cadence_keeps_a_graph_for_each_of_its_keys():
    """``vert_t_every`` 2 alternates two keys of phases 1-2: each is seen
    once, captured once, then replayed, with no capture after the fourth
    step; bit-equal to eager steps."""
    cfg = CONFIGS["mscmrseg"]()
    batches = _batches(cfg, 8, without_vert_t=(1, 3, 5, 7))
    eager = _run(cfg, batches)
    graphed = _run(cfg, batches, graphed=BLOCKS)
    _assert_same(eager[:2], graphed[:2])
    assert graphed[2] == {"gen": 2, "disc": 1}
    assert _calls(graphed[3], timer.GEN_REPLAY) == 6 and _calls(graphed[3], timer.DISC_REPLAY) == 7
    assert ["ver_t_loss" in m for m in graphed[1]] == [True, False] * 4
    assert len(graphed[4].gen_graphs._graphs) == 2


@pytest.mark.parametrize("replaced", ["optimizer_state", "generator"])
def test_a_replaced_buffer_or_generator_asks_for_a_new_capture(replaced):
    """``opt.load_state_dict`` of a saved state (what ``restore_full`` does)
    gives the discriminators new momentum buffers, and a new dropout
    generator is another object: the next step captures again, and the run
    stays bit-equal to an eager one that did the same."""
    cfg = CONFIGS["mmwhs"]()

    def hook(i, st):
        if i != 3:
            return
        if replaced == "generator":
            gen = torch.Generator(device="cpu")
            gen.set_state(st.generator.get_state())
            st.generator = gen
            return
        for opt in st.optimizers:
            buf = io.BytesIO()
            torch.save(opt.state_dict(), buf)
            buf.seek(0)
            opt.load_state_dict(torch.load(buf, weights_only=True))

    batches = _batches(cfg, 5)
    eager = _run(cfg, batches, hook=hook)
    graphed = _run(cfg, batches, graphed=BLOCKS, hook=hook)
    _assert_same(eager[:2], graphed[:2])
    # a restored optimiser leaves phases 1-2's tensors as they were (Adam's moments are the eager update's)
    assert graphed[2] == {"gen": 2 if replaced == "generator" else 1, "disc": 2}
    assert _calls(graphed[3], timer.DISC_CAPTURE) == 2 and _calls(graphed[3], timer.DISC_REPLAY) == 4
    assert _calls(graphed[3], timer.GEN_REPLAY) == 4


@pytest.mark.parametrize("replaced", ["parameter", "bn_buffer", "generator"])
def test_a_replaced_parameter_bn_buffer_or_generator_recaptures_phases_1_2(replaced):
    """Phases 1-2 read every network's parameters and write the BatchNorm
    running statistics in place: a parameter given other memory, a running
    statistic replaced by another tensor, or another dropout generator asks
    for a new capture of phases 1-2, and the run stays bit-equal to an eager
    one that did the same."""
    cfg = CONFIGS["mscmrseg"]()

    def hook(i, st):
        if i != 3:
            return
        gen = st.models[0]
        if replaced == "parameter":
            p = next(gen.parameters())
            p.data = p.data.clone()
        elif replaced == "bn_buffer":
            bn = next(m for m in gen.modules() if hasattr(m, "running_mean"))
            bn.running_mean = bn.running_mean.clone()
        else:
            g = torch.Generator(device="cpu")
            g.set_state(st.generator.get_state())
            st.generator = g

    batches = _batches(cfg, 5)
    eager = _run(cfg, batches, hook=hook)
    graphed = _run(cfg, batches, graphed=("gen",), hook=hook)
    _assert_same(eager[:2], graphed[:2])
    assert graphed[2]["gen"] == 2
    assert _calls(graphed[3], timer.GEN_CAPTURE) == 2 and _calls(graphed[3], timer.GEN_REPLAY) == 4


def test_a_changed_generator_lr_needs_no_new_capture():
    """The generator's update runs eagerly after the replay, so the decayed
    lr (``set_generator_lr``, what ``fit`` does every ``decay_e`` epochs)
    takes effect at once with the graph captured before it."""
    cfg = CONFIGS["mscmrseg"]()

    def hook(i, st):
        if i == 3:
            set_generator_lr(st, 0.2 * st.optimizers[0].param_groups[0]["lr"])

    batches = _batches(cfg, 5)
    eager = _run(cfg, batches, hook=hook)
    graphed = _run(cfg, batches, graphed=BLOCKS, hook=hook)
    _assert_same(eager[:2], graphed[:2])
    assert graphed[2] == {"gen": 1, "disc": 1}
    assert _calls(graphed[3], timer.GEN_REPLAY) == 4


def test_a_padded_tail_runs_eagerly_and_the_next_batch_replays():
    """A tail batch (a ``sample_mask``: another key, seen once) runs eagerly
    between replays and leaves gradients of its own; the next full batch
    replays the graph captured before, with no new capture, and every replay
    finds the gradients pointed back at the graph's, in both blocks."""
    cfg = CONFIGS["mscmrseg"]()
    batches = _batches(cfg, 5, tail_at=(2,))
    eager = _run(cfg, batches)
    st = create_train_state(cfg, seed=3, device="cpu")
    step = make_train_step(cfg, st.models, st.optimizers)
    found = {block: [] for block in BLOCKS}
    for block, nets in (("gen", st.models[:1]), ("disc", st.models[1:])):
        params = [p for m in nets if m is not None for p in m.parameters()]

        class Watching(StandIn):
            def replay(self, block=block, params=params):
                found[block].append([p.grad for p in params])
                return super().replay()

        graphs = getattr(step, f"{block}_graphs")
        graphs.on_card, graphs.make_graph = True, Watching
    timer.reset_spans()
    metrics = []
    for b in batches:
        st, m = step(st, b)
        metrics.append(m)
    _assert_same(eager[:2], (st, metrics))
    totals = timer.span_totals()
    assert _calls(totals, timer.DISC_CAPTURE) == 1 and _calls(totals, timer.GEN_CAPTURE) == 1
    assert _calls(totals, timer.DISC_REPLAY) == 3 and _calls(totals, timer.GEN_REPLAY) == 3  # steps 2, 4 and 5
    for block in BLOCKS:
        (captured,) = getattr(step, f"{block}_graphs")._graphs.values()
        assert len(found[block]) == 3
        assert all(all(a is b for a, b in zip(seen, captured.grads)) for seen in found[block])


def test_a_blocks_captures_share_one_memory_pool():
    """A block's graphs replay one at a time on one stream, so a capture
    takes its memory from the pool of the block's live graphs: the cadence's
    two graphs of phases 1-2 share one, and so do their captures made again
    for a new dropout generator, each beside the other key's graph. Phases
    3-5 have a pool of their own, and their one graph, dropped before it is
    captured again, leaves the new capture a pool of its own."""
    cfg = CONFIGS["mscmrseg"]()
    pools = {block: [] for block in BLOCKS}

    class Pooled(StandIn):
        def __init__(self, body, generator, pool=None):
            super().__init__(body, generator, pool)
            pools[self.block].append((pool, self.pool))

    def hook(i, st):
        if i == 5:  # another generator: both blocks capture again
            g = torch.Generator(device="cpu")
            g.set_state(st.generator.get_state())
            st.generator = g

    st = create_train_state(cfg, seed=3, device="cpu")
    step = make_train_step(cfg, st.models, st.optimizers)
    for block in BLOCKS:
        graphs = getattr(step, f"{block}_graphs")
        graphs.on_card, graphs.make_graph = True, type(block, (Pooled,), {"block": block})
    for i, b in enumerate(_batches(cfg, 8, without_vert_t=(1, 3, 5, 7))):
        hook(i, st)
        st, _ = step(st, b)
    assert [len(pools[block]) for block in BLOCKS] == [4, 2]  # gen: 2 keys, twice each; disc: once, then again
    (given, first), *later = pools["gen"]
    assert given is None and all(given is first and made is first for given, made in later)
    (given, first), (again, second) = pools["disc"]
    assert given is None and again is None and second is not first and first is not pools["gen"][0][1]
