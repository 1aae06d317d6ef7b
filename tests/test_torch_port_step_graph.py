"""Phases 3-5 of the train step from one CUDA graph
(``pointcloududa_torch/train/disc_graph.py``), held on the CPU with the
capture mocked: when the step engages the graph and when it runs the block
eagerly, what a graph is keyed by, the guard that asks for a new capture, and
a stand-in for the graph that runs the captured block again at each replay,
through which K steps equal K eager steps bit for bit (the inputs copied in,
the metrics copied out, the gradients pointed back, the keys and the cache).
A real graph against eager steps is held on the card, in
``test_torch_port_cuda.py``. Imports no JAX."""

import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pointcloududa_torch.config import mmwhs_default, mscmrseg_default
from pointcloududa_torch.data.synthetic import synthetic_batch
from pointcloududa_torch.train import disc_graph
from pointcloududa_torch.train.state import create_train_state
from pointcloududa_torch.train.step import make_train_step
from pointcloududa_torch.utils import timer

SMALL = dict(filters=4, crop_size=32, n_block=2, fc_inch=9, bs=2)
# the two paper configurations' discriminators at a small size
CONFIGS = {
    "mscmrseg": lambda: mscmrseg_default(d1=True, d2=True, d4=True, **SMALL),
    "mmwhs": lambda: mmwhs_default(d1=True, d2=True, d4=True, ft=True, extd4=True, softmax=True, d1_on_probs=True,
                                   entropy_norm=True, **SMALL),
}
D_SPANS = [f"uda.step.d{k}.{part}" for k in (1, 2, 4) for part in ("forward", "backward", "update")]


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
    writes its metrics into the captured output, as a replay rewrites it."""

    def __init__(self, body, generator):
        self.body, self.out, self.fresh = body, body(), True

    def replay(self):
        if not self.fresh:
            self.out.copy_(self.body())
        self.fresh = False
        return self.out


def _batches(cfg, n, tail_at=()):
    out = []
    for s in range(n):
        b = synthetic_batch(cfg, cfg.bs, seed=s)
        if s in tail_at:
            b["sample_mask"] = np.array([1] + [0] * (cfg.bs - 1), np.float32)
        out.append(b)
    return out


def _run(cfg, batches, graphed, hook=None, make_graph=StandIn):
    """K steps from one seed; ``graphed``: the step takes the card's route
    with ``make_graph`` in place of a CUDA graph. Returns the state, each
    step's metrics, the number of captures and the span totals."""
    st = create_train_state(cfg, seed=3, device="cpu")
    step = make_train_step(cfg, st.models, st.optimizers)
    captures = []
    if graphed:
        step.disc_graphs.on_card = True
        step.disc_graphs.make_graph = lambda body, gen: captures.append(gen) or make_graph(body, gen)
    timer.reset_spans()
    metrics = []
    for i, b in enumerate(batches):
        if hook is not None:
            hook(i, st)
        st, m = step(st, b)
        metrics.append(m)
    return st, metrics, len(captures), timer.span_totals(), step


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
            for pa, pb in zip(oa.state.values(), ob.state.values()):
                for k in pa:
                    assert torch.equal(torch.as_tensor(pa[k]), torch.as_tensor(pb[k])), k
    assert torch.equal(sa.generator.get_state(), sb.generator.get_state())
    assert len(ma) == len(mb)
    for i, (x, y) in enumerate(zip(ma, mb)):
        assert list(x) == list(y)
        for k in x:
            assert torch.equal(x[k], y[k]), (i, k)


def _refuse(body, gen):
    raise AssertionError("captured where the step should run phases 3-5 eagerly")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stand_in_graph_steps_equal_eager_steps(name):
    """Six steps: the first runs eagerly (the warm-up), the second captures
    and replays, the rest replay; all bit-equal to six eager steps, each
    step's metrics a tensor of its own."""
    cfg = CONFIGS[name]()
    batches = _batches(cfg, 6)
    eager = _run(cfg, batches, graphed=False)
    graphed = _run(cfg, batches, graphed=True)
    _assert_same(eager[:2], graphed[:2])
    assert graphed[2] == 1
    totals = graphed[3]
    assert _calls(totals, timer.DISC_CAPTURE) == 1 and _calls(totals, timer.DISC_REPLAY) == 5
    assert eager[2] == 0 and _calls(eager[3], timer.DISC_REPLAY) == 0
    storages = {m["d4_loss"].untyped_storage().data_ptr() for m in graphed[1]}
    assert len(storages) == 6


@pytest.mark.parametrize("case", ["cpu", "mesh", "anomaly", "key_seen_once"])
def test_eager_where_the_graph_does_not_engage(case, monkeypatch):
    """On a CPU device, under a data mesh, in anomaly mode, and for inputs
    or hyper-parameters seen once, phases 3-5 run eagerly: today's results
    bit for bit, the discriminators' spans fire every step and no replay."""
    cfg = CONFIGS["mmwhs"]()
    tail_at, hook = (), None
    if case == "key_seen_once":  # a full batch, a padded tail, then D1 at another lr
        tail_at = (1,)

        def hook(i, st):
            if i == 2:
                st.optimizers[1].param_groups[0]["lr"] *= 0.5

    batches = _batches(cfg, 3, tail_at)
    want = _run(cfg, batches, graphed=False, hook=hook)
    if case == "mesh":
        monkeypatch.setattr(disc_graph, "collectives", SimpleNamespace(active=lambda: True))
    with torch.autograd.set_detect_anomaly(case == "anomaly"):
        got = _run(cfg, batches, graphed=case != "cpu", hook=hook, make_graph=_refuse)
    _assert_same(want[:2], got[:2])
    assert got[2] == 0 and _calls(got[3], timer.DISC_REPLAY) == 0 and _calls(got[3], timer.DISC_CAPTURE) == 0
    assert all(_calls(got[3], span) == 3 * (2 if span.endswith("update") else 1) for span in D_SPANS)


def test_the_key_follows_the_inputs_and_the_hyper_parameters():
    """A graph holds its inputs' shapes and dtypes and the optimisers'
    hyper-parameters as constants: a change of any is another key."""
    cfg = CONFIGS["mscmrseg"]()
    st = create_train_state(cfg, seed=0, device="cpu")
    opts = [o for o in st.optimizers[1:] if o is not None]
    x = {"d1_src": torch.zeros(2, 8, 8, 4), "d1_tgt": torch.zeros(2, 8, 8, 4)}
    key = disc_graph.graph_key(x, opts)
    assert disc_graph.graph_key({k: v.clone() for k, v in x.items()}, opts) == key
    others = [
        {**x, "sample_mask": torch.ones(2)},
        {**x, "d1_tgt": torch.zeros(2, 8, 8, 5)},
        {**x, "d1_tgt": torch.zeros(2, 8, 8, 4, dtype=torch.bfloat16)},
    ]
    assert all(disc_graph.graph_key(o, opts) != key for o in others)
    for field, value in (("lr", 1e-3), ("momentum", 0.5), ("weight_decay", 0.0)):
        before = opts[0].param_groups[0][field]
        opts[0].param_groups[0][field] = value
        assert disc_graph.graph_key(x, opts) != key, field
        opts[0].param_groups[0][field] = before
    assert disc_graph.graph_key(x, opts) == key


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
    eager = _run(cfg, batches, graphed=False, hook=hook)
    graphed = _run(cfg, batches, graphed=True, hook=hook)
    _assert_same(eager[:2], graphed[:2])
    assert graphed[2] == 2 and _calls(graphed[3], timer.DISC_CAPTURE) == 2
    assert _calls(graphed[3], timer.DISC_REPLAY) == 4


def test_a_padded_tail_runs_eagerly_and_the_next_batch_replays():
    """A tail batch (a ``sample_mask``: another key, seen once) runs eagerly
    between replays and leaves gradients of its own; the next full batch
    replays the graph captured before, with no new capture, and every replay
    finds the gradients pointed back at the graph's."""
    cfg = CONFIGS["mscmrseg"]()
    batches = _batches(cfg, 5, tail_at=(2,))
    found = []

    class Watching(StandIn):
        def replay(self):
            found.append([p.grad for p in self.params])
            return super().replay()

    def make_graph(body, gen):
        graph = Watching(body, gen)
        graph.params = [p for m in st_box for p in m.parameters()]
        return graph

    st_box = []
    eager = _run(cfg, batches, graphed=False)
    graphed = _run(cfg, batches, graphed=True, make_graph=make_graph,
                   hook=lambda i, st: st_box or st_box.extend(m for m in st.models[1:] if m is not None))
    _assert_same(eager[:2], graphed[:2])
    assert graphed[2] == 1
    assert _calls(graphed[3], timer.DISC_REPLAY) == 3  # steps 2, 4 and 5
    (captured,) = graphed[4].disc_graphs._graphs.values()
    assert len(found) == 3 and all(all(a is b for a, b in zip(seen, captured.grads)) for seen in found)
