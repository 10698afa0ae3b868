"""The port's train step against ``repro``'s, on ``repro``'s weights
(``from_jax_params``) at ``smoke_config`` in float32, one config a
family: the loss, every gradient and the weights after a step; for
qwen3-4b also several steps, microbatches, remat, both CE forms, a state
carried over from ``repro``, resume and a falling loss; then the
launcher and the example as subprocesses on the CPU.

``repro``'s side runs jitted (cheaper than eager here), without remat;
its weights are built once a config, per module.
"""

import concurrent.futures
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro.training import trainer as JTr
from repro_torch.configs import smoke_config
from repro_torch.launch import train as train_cli
from repro_torch.models.transformer import param_shapes
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as O
from repro_torch.training import trainer as Tr
from repro_torch.weights import from_jax_params, from_jax_train_state
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
B, T = 2, 24
LR, WARMUP, TOTAL = 1e-3, 2, 10
# arch, config overrides: llama4-scout's smoke capacity is 0 (no drops),
# so it also runs at capacity 1.0, where choices drop
CASES = {
    "qwen3-4b": ("qwen3-4b", {}),
    "gemma3-1b": ("gemma3-1b", {}),
    "llama4-scout": ("llama4-scout-17b-a16e", {}),
    "llama4-scout-cap1": ("llama4-scout-17b-a16e",
                          {"capacity_factor": 1.0}),
    "kimi-k2": ("kimi-k2-1t-a32b", {}),
    "mamba2": ("mamba2-2.7b", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "llava-next": ("llava-next-34b", {}),
    "whisper": ("whisper-base", {}),
}
# launch/specs.py gives kimi Adafactor; the rest run AdamW
OPTIMIZER = {"kimi-k2": "adafactor"}
# gradients: |port - repro| <= GRAD_TOL * max|g| + 1e-7, max over the
# whole gradient.  jamba's smoke model stacks 16 layers, 14 of them Mamba
# mixers whose SSD takes each of repro's three-operand products as a
# scaling and then one matmul (another float32 rounding order): its
# logits already part by 8.6e-6 of their max, and its gradient by 7.0e-5
# of max|g| (repro's jitted, eager and remat gradients agree within
# 1.6e-6 of each other, sharing one contraction order)
GRAD_TOL = {"jamba": 1e-4}


def _numpy_params(jcfg, rng):
    """Weights in ``repro``'s parameter tree (the shapes and dtypes of
    its ``init_params``, traced by ``jax.eval_shape``, nothing compiled),
    drawn in numpy: matrices N(0, 1/fan_in), the embedding N(0, 1/d),
    norm scales and Mamba's ``D`` near 1, other vectors near 0."""
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                            jax.random.PRNGKey(0))

    def draw(path, sd):
        name = str(getattr(path[-1], "key", ""))
        x = rng.standard_normal(sd.shape)
        if name == "embed":
            x = x / np.sqrt(jcfg.d_model)
        elif len(sd.shape) >= 2 and (len(sd.shape) >= 3
                                     or path[0].key != "blocks"):
            x = x / np.sqrt(sd.shape[-2])
        elif name in ("scale", "norm", "D"):
            x = 1 + 0.1 * x
        else:
            x = 0.1 * x
        return x.astype(sd.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _optimizers(name):
    kind = OPTIMIZER.get(name, "adamw")
    return (JO.make_optimizer(kind, JO.cosine_schedule(LR, WARMUP, TOTAL)),
            O.make_optimizer(kind, O.cosine_schedule(LR, WARMUP, TOTAL)))


class Case:
    """One config: ``repro``'s weights and its loss and gradient on one
    seeded batch (with stub frontend inputs), built once."""

    def __init__(self, name):
        arch, over = CASES[name]
        self.name = name
        self.jcfg = dataclasses.replace(jax_smoke_config(arch), **over)
        self.cfg = dataclasses.replace(smoke_config(arch), **over)
        rng = np.random.default_rng(7)
        self.np_params = _numpy_params(self.jcfg, rng)
        self.jparams = jax.tree.map(jnp.asarray, self.np_params)
        self.tokens = rng.integers(0, self.cfg.vocab_size, (B, T))
        self.labels = rng.integers(0, self.cfg.vocab_size, (B, T))
        self.extras = {}
        cfg = self.cfg
        if cfg.frontend in ("vision", "audio"):
            key = ("prefix_embeds" if cfg.frontend == "vision"
                   else "encoder_embeds")
            self.extras[key] = rng.standard_normal(
                (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
        self.args = (jnp.asarray(self.tokens), jnp.asarray(self.labels),
                     {k: jnp.asarray(v) for k, v in self.extras.items()})
        self.lowered = _repro_reference.lower(
            self.jcfg, OPTIMIZER.get(name, "adamw"), self.jparams,
            *self.args)

    def finish(self, compiled):
        """Run ``repro``'s compiled reference step."""
        (loss, met), grads, new = compiled(self.jparams, *self.args)
        self.loss = float(loss)
        self.met = {k: float(v) for k, v in met.items()}
        self.grads = {k: v.numpy() for k, v in from_jax_params(
            self.cfg, jax.tree.map(np.asarray, grads)).items()}
        # repro's weights after its step: its clip and update over its
        # own (period-stacked) tree, as its make_train_step
        self.stepped = {k: v.numpy() for k, v in from_jax_params(
            self.cfg, jax.tree.map(np.asarray, new)).items()}
        del self.lowered

    def extras_fn(self, tokens):
        return {k: torch.from_numpy(v) for k, v in self.extras.items()}

    def state(self, topt):
        params = from_jax_params(self.cfg, self.np_params)
        return Tr.make_state(self.cfg, params, topt.init(params))

    def batch(self):
        return torch.from_numpy(self.tokens), torch.from_numpy(self.labels)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _repro_reference(jcfg, kind, params, tokens, labels, extras):
    """``repro``'s loss, gradient and weights after one step (its loss
    without remat, ``clip_by_global_norm`` and the optimizer's update:
    the body of its ``make_train_step``), compiled once."""
    jopt = JO.make_optimizer(kind, JO.cosine_schedule(LR, WARMUP, TOTAL))
    (loss, met), grads = jax.value_and_grad(
        JTr.make_loss_fn(jcfg, remat=False), has_aux=True)(
        params, tokens, labels, extras)
    clipped, _ = JO.clip_by_global_norm(grads, 1.0)
    upd, _ = jopt.update(clipped, jopt.init(params), params)
    return (loss, met), grads, jax.tree.map(jnp.add, params, upd)


_CACHE = {}


def _cases():
    """Every case, built once: each reference step traced in turn, then
    all compiled at once on a few threads (XLA compiles without the
    GIL), then run."""
    if not _CACHE:
        cases = [Case(name) for name in CASES]
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            compiled = list(pool.map(lambda c: c.lowered.compile(), cases))
        for c, fn in zip(cases, compiled):
            c.finish(fn)
            _CACHE[c.name] = c
    return _CACHE


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return _cases()[request.param]


def _port_loss_and_grads(case, remat=False, ce_impl="gather"):
    st = case.state(_optimizers(case.name)[1])
    loss_fn = Tr.make_loss_fn(case.cfg, remat=remat, ce_impl=ce_impl)
    loss, met = loss_fn(st.model, *case.batch(), case.extras_fn(None))
    names = list(st.params)
    grads = torch.autograd.grad(loss, [st.params[k] for k in names],
                                allow_unused=True)
    return float(loss.detach()), {k: float(v.detach())
                                  for k, v in met.items()}, {
        k: (np.zeros(st.params[k].shape, np.float32) if g is None
            else g.numpy()) for k, g in zip(names, grads)}


def _assert_grads_close(got, want, tol):
    assert set(got) == set(want)
    gmax = max(float(np.abs(g).max()) for g in want.values())
    for k in want:
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= tol * gmax + 1e-7, (k, err, gmax)


def test_loss_and_grads_match_repro(case):
    loss, met, grads = _port_loss_and_grads(case)
    assert abs(loss - case.loss) <= 1e-5 * abs(case.loss)
    for k in ("ce", "moe_aux"):
        assert abs(met[k] - case.met[k]) <= 1e-5 * abs(case.met[k]), k
    if case.cfg.num_experts:
        assert met["moe_aux"] > 0
    _assert_grads_close(grads, case.grads, GRAD_TOL.get(case.name, 1e-5))
    # remat recomputes each period in the backward: the same gradient
    loss_r, _, grads_r = _port_loss_and_grads(case, remat=True)
    assert abs(loss_r - loss) <= 1e-7 * abs(loss)
    _assert_grads_close(grads_r, grads, 1e-6)


def first_step_tol(w_ref, g_ref, tau, lr, eps):
    """Adam's first step (and Adafactor's on an unfactored leaf, with
    eps 1e-9) moves a weight by ``lr * g / (|g| + eps)`` (plus the same
    decay on both sides), so a gradient known within ``tau`` gives a
    weight within ``lr * tau * eps / (max(|g| - tau, 0) + eps)^2``, at
    most ``2 lr`` where ``|g| <= tau`` (a near-zero gradient's sign is
    noise); plus float32 rounding of the step and the weight."""
    near = np.maximum(np.abs(g_ref) - tau, 0.0) + eps
    return (lr * (np.minimum(2.0, tau * eps / near ** 2) + 1e-6)
            + 1e-6 * np.abs(w_ref))


def factored_first_step_tol(w_ref, g_ref, tau, lr):
    """Adafactor's first step on a factored leaf divides ``g`` by
    ``sqrt(r_i) sqrt(vc_j)``, row and column means of ``g^2``: a gradient
    known within ``tau`` moves the step by at most ~``2 tau / den``."""
    g2 = g_ref.astype(np.float64) ** 2 + 1e-30
    vr, vc = g2.mean(-1), g2.mean(-2)
    r = vr / np.maximum(vr.mean(-1, keepdims=True), 1e-30)
    den = np.sqrt(r)[..., None] * np.sqrt(vc)[..., None, :] + 1e-9
    return (lr * (np.minimum(2 * np.abs(g_ref) / den + 2.0,
                             2 * tau / den) + 1e-6)
            + 1e-6 * np.abs(w_ref))


def test_weights_after_one_step_match_repro(case):
    kind = OPTIMIZER.get(case.name, "adamw")
    _, topt = _optimizers(case.name)
    st = case.state(topt)
    step = Tr.make_train_step(case.cfg, topt, remat=False,
                              extras_fn=case.extras_fn)
    st, met = step(st, case.batch())
    got = {k: v.detach().numpy() for k, v in st.params.items()}
    assert int(st.step) == 1
    assert abs(float(met["loss"]) - case.loss) <= 1e-5 * abs(case.loss)
    # the step's clip and optimizer: the port's over repro's gradient give
    # repro's weights after its step
    p0 = from_jax_params(case.cfg, case.np_params)
    g = {k: torch.from_numpy(v) for k, v in case.grads.items()}
    clipped, _ = O.clip_by_global_norm(g, 1.0)
    upd, _ = topt.update(clipped, topt.init(p0), p0)
    mine = {k: (p0[k] + upd[k]).numpy() for k in p0}
    parted = []
    for k, w in case.stepped.items():
        if np.allclose(mine[k], w, rtol=1e-6, atol=1e-6 * LR):
            continue
        # repro's Adafactor factors a period-stacked 1-d leaf (a norm
        # scale) across layers; the port's leaf is per layer
        assert kind == "adafactor" and w.ndim == 1 and k.startswith(
            "layers."), (k, float(np.abs(mine[k] - w).max()))
        parted.append(k)
    assert (kind == "adafactor") == bool(parted), parted
    assert all(k.endswith("scale") for k in parted), parted
    # end to end: the port's step against that update of repro's gradient,
    # within the step's sensitivity to the gradient's tolerance
    lr1 = float(JO.cosine_schedule(LR, WARMUP, TOTAL)(1))
    gmax = max(float(np.abs(v).max()) for v in case.grads.values())
    scale = float(O.global_norm(g))
    scale = min(1.0, 1.0 / scale)                   # the clip
    tau = (GRAD_TOL.get(case.name, 1e-5) * gmax + 1e-7) * scale
    for k in got:
        w, gk = mine[k], case.grads[k] * scale
        if kind == "adamw":
            tol = first_step_tol(w, gk, tau, lr1, 1e-8)
        elif gk.ndim >= 2:
            tol = factored_first_step_tol(w, gk, tau, lr1)
        else:
            tol = first_step_tol(w, gk, tau, lr1, 1e-9)
        assert np.all(np.abs(got[k] - w) <= tol), (
            k, float(np.max(np.abs(got[k] - w) - tol)))


def test_adafactor_state_does_not_carry_over():
    """``repro``'s Adafactor factors the period-stacked norm scales
    across layers: ``from_jax_train_state`` refuses its state."""
    cfg = smoke_config("kimi-k2-1t-a32b")
    jcfg = jax_smoke_config("kimi-k2-1t-a32b")
    params = jax.tree.map(jnp.asarray,
                          _numpy_params(jcfg, np.random.default_rng(0)))
    jopt = JO.make_optimizer("adafactor", JO.cosine_schedule(LR, 2, 10))
    state = JTr.TrainState(jnp.zeros((), jnp.int32), params,
                           jopt.init(params))
    slots = state.opt_state["slots"]["blocks"]["sub0"]["ln"]["scale"]
    assert set(slots) == {"vr", "vc"}          # factored across periods
    with pytest.raises(ValueError, match="Adafactor"):
        from_jax_train_state(cfg, jax.tree.map(np.asarray, state))


# --------------------------------------------------------------------- #
# qwen3-4b: steps, microbatches, remat, CE forms, carry-over, resume
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def qwen():
    return _cases()["qwen3-4b"]


def _jax_state(case, jopt):
    return JTr.TrainState(jnp.zeros((), jnp.int32), case.jparams,
                          jopt.init(case.jparams))


def _batches(case, n, seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, case.cfg.vocab_size, (4, 16)),
             rng.integers(0, case.cfg.vocab_size, (4, 16)))
            for _ in range(n)]


def _assert_states_close(st, jstate, cfg, steps):
    """Weights after ``steps`` Adam steps from one start: an update is at
    most ~lr a step, and where a gradient is within its tolerance of zero
    its sign, and so that step's update, is noise (up to 2 lr); elsewhere
    the weights agree to float32 rounding.  So: every weight within
    ``2 lr steps``, and all but a 1e-3 share within rounding."""
    want = from_jax_params(cfg, jax.tree.map(np.asarray, jstate.params))
    n = off = 0
    for k, v in st.params.items():
        a, b = v.detach().numpy(), want[k].numpy()
        d = np.abs(a - b)
        assert d.max() <= 2 * LR * steps, (k, float(d.max()))
        off += int(np.sum(d > 1e-5 * np.abs(b) + 1e-6 * LR * steps))
        n += d.size
    assert off <= 1e-3 * n, (off, n)


def test_three_steps_and_carried_state_match_repro(qwen):
    """Three steps against repro's; then a state trained two steps in
    repro and carried over goes on two port steps as repro's four."""
    jopt, topt = _optimizers(qwen.name)
    jstep = jax.jit(JTr.make_train_step(qwen.jcfg, jopt, remat=False))
    tstep = Tr.make_train_step(qwen.cfg, topt, remat=False)
    data = _batches(qwen, 4)
    js, ts = _jax_state(qwen, jopt), qwen.state(topt)
    jstates = []
    for i in range(3):
        js, jm = jstep(js, tuple(map(jnp.asarray, data[i])))
        ts, tm = tstep(ts, tuple(map(torch.from_numpy, data[i])))
        jstates.append(js)
        for k in ("loss", "grad_norm", "ce"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(
                float(jm[k])), (i, k)
    _assert_states_close(ts, js, qwen.cfg, 3)
    assert int(ts.step) == 3
    # carry repro's state after two steps over, then two port steps
    carried = from_jax_train_state(
        qwen.cfg, jax.tree.map(np.asarray, jstates[1]))
    assert int(carried.step) == 2 and int(carried.opt_state["count"]) == 2
    for k, v in carried.opt_state["m"].items():
        assert v.shape == carried.params[k].shape
    js4 = jstates[1]
    for i in (2, 3):
        carried, tm = tstep(carried, tuple(map(torch.from_numpy, data[i])))
        js4, jm = jstep(js4, tuple(map(jnp.asarray, data[i])))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
            float(jm["loss"]))
    _assert_states_close(carried, js4, qwen.cfg, 4)
    want_m = from_jax_params(qwen.cfg, jax.tree.map(
        np.asarray, js4.opt_state["m"]))
    for k, v in carried.opt_state["m"].items():
        np.testing.assert_allclose(v.numpy(), want_m[k].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


_MICRO = {}


def _microbatch_refs(qwen):
    """``repro``'s step at 2 and 4 microbatches, scanned and unrolled, on
    one batch each: ``{(mb, unroll): (state, metrics)}``; the four traced
    in turn, then compiled at once on threads."""
    if not _MICRO:
        jopt, _ = _optimizers(qwen.name)
        runs = []
        for mb in (2, 4):
            batch = tuple(map(jnp.asarray, _batches(qwen, 1, seed=mb)[0]))
            for unroll in (False, True):
                fn = jax.jit(JTr.make_train_step(
                    qwen.jcfg, jopt, microbatches=mb, remat=False,
                    unroll=unroll))
                args = (_jax_state(qwen, jopt), batch)
                runs.append(((mb, unroll), fn.lower(*args), args))
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            compiled = list(pool.map(lambda r: r[1].compile(), runs))
        for (key, _, args), fn in zip(runs, compiled):
            _MICRO[key] = fn(*args)
    return _MICRO


@pytest.mark.parametrize("mb", [2, 4])
def test_microbatches_match_repro_scan_and_unrolled(qwen, mb):
    _, topt = _optimizers(qwen.name)
    toks, labels = _batches(qwen, 1, seed=mb)[0]
    ts, tm = Tr.make_train_step(qwen.cfg, topt, microbatches=mb,
                                remat=False)(
        qwen.state(topt), (torch.from_numpy(toks), torch.from_numpy(labels)))
    one = Tr.make_train_step(qwen.cfg, topt, remat=False)(
        qwen.state(topt), (torch.from_numpy(toks), torch.from_numpy(labels)))
    for unroll in (False, True):
        js, jm = _microbatch_refs(qwen)[mb, unroll]
        for k in ("loss", "grad_norm", "ce", "moe_aux"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(
                float(jm[k])), (unroll, k)
        _assert_states_close(ts, js, qwen.cfg, 1)
    # the accumulated loss equals the whole batch's
    assert abs(float(tm["loss"]) - float(one[1]["loss"])) <= 1e-5 * float(
        one[1]["loss"])


def test_remat_and_ce_forms_give_one_step(qwen):
    _, topt = _optimizers(qwen.name)
    batch = qwen.batch()
    runs = {}
    for remat in (False, True):
        for ce in ("gather", "onehot"):
            st, met = Tr.make_train_step(qwen.cfg, topt, remat=remat,
                                         ce_impl=ce)(qwen.state(topt), batch)
            runs[remat, ce] = (float(met["loss"]), st)
    base_loss, base = runs[False, "gather"]
    assert abs(base_loss - qwen.loss) <= 1e-5 * qwen.loss
    for key, (loss, st) in runs.items():
        assert abs(loss - base_loss) <= 1e-6 * base_loss, key
        for k, v in st.params.items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       base.params[k].detach().numpy(),
                                       rtol=1e-6, atol=1e-6 * LR,
                                       err_msg=(key, k))


def test_resume_from_checkpoint_is_bitwise(qwen, tmp_path):
    """4 steps straight equal 2 steps, a checkpoint, a reload into a fresh
    state and 2 more, bit for bit, at f32 and at bf16 weights."""
    for dtype in (torch.float32, torch.bfloat16):
        _, topt = _optimizers(qwen.name)
        step = Tr.make_train_step(qwen.cfg, topt, remat=False)
        data = [tuple(map(torch.from_numpy, b)) for b in _batches(qwen, 4)]

        def fresh():
            params = {k: v.to(dtype) if v.dtype == torch.float32 else v
                      for k, v in from_jax_params(
                          qwen.cfg, qwen.np_params).items()}
            return Tr.make_state(qwen.cfg, params, topt.init(params))

        straight = fresh()
        for b in data:
            straight, _ = step(straight, b)
        st = fresh()
        for b in data[:2]:
            st, _ = step(st, b)
        d = str(tmp_path / str(dtype))
        ckpt.save_checkpoint(d, 2, st, num_shards=2)
        step_n, st, _ = ckpt.load_latest(d, fresh())
        assert step_n == 2 and int(st.step) == 2
        assert st.params["embed"].dtype == dtype
        for b in data[2:]:
            st, _ = step(st, b)
        for a, b in ((st.params, straight.params),
                     (st.opt_state["m"], straight.opt_state["m"]),
                     (st.opt_state["v"], straight.opt_state["v"])):
            for k in b:
                assert torch.equal(a[k], b[k]), (dtype, k)
        assert int(st.opt_state["count"]) == 4


def test_loss_falls_on_two_cycled_batches():
    """As ``test_models.py``'s tiny-model check: 25 steps over two cycled
    batches lower the loss by 0.5."""
    from repro_torch.training.data import DataConfig, SyntheticLM
    cfg = smoke_config("gemma-2b")
    opt = O.make_optimizer("adamw", O.cosine_schedule(3e-3, 2, 50))
    st = Tr.init_state(cfg, opt, torch.Generator().manual_seed(0),
                       device="cpu")
    step = Tr.make_train_step(cfg, opt, remat=False)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4))
    losses = []
    for i in range(25):
        st, m = step(st, tuple(map(torch.from_numpy, data.batch(i % 2))))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, losses[::6]


def test_abstract_state_allocates_nothing():
    cfg = smoke_config("qwen3-4b")
    st = Tr.abstract_state(cfg, O.adamw(O.cosine_schedule(LR, 2, 10)))
    assert all(v.is_meta for v in st.params.values())
    nb = Tr.state_bytes(st)
    assert nb["n_params"] == sum(int(np.prod(s)) for s, _ in
                                 param_shapes(cfg).values())
    assert nb["opt_state"] == 2 * nb["params"] + 4


# --------------------------------------------------------------------- #
# the launcher and the example, as subprocesses on the CPU
# --------------------------------------------------------------------- #
def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="4")
    res = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=timeout, cwd=str(ROOT), env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_train_cli_resumes_and_restarts_elastically(tmp_path, capsys):
    """Two steps that checkpoint (in-process), then the CLI as a
    subprocess: it resumes there on a data axis of 2 and loses half of it
    at step 3.  ``--model 2`` is refused."""
    args = ["--smoke", "--device", "cpu", "--global-batch", "4",
            "--seq-len", "16", "--ckpt-dir", str(tmp_path)]
    assert train_cli.main(args + ["--steps", "2"]) == 0
    assert "[ckpt] saved step 2 final" in capsys.readouterr().out
    out = _run(["-m", "repro_torch.launch.train", *args, "--steps", "6",
                "--data", "2", "--fail-at-step", "3", "--ckpt-every", "4"])
    assert f"[resume] step 2 from {tmp_path}" in out
    assert "[elastic] step 3: simulating loss of half the data axis " \
        "(2 -> 1)" in out
    assert "[ckpt] saved step 3 pre-failure" in out
    assert "[ckpt] saved step 4 " in out
    assert "step    5 loss" in out and "done: 4 steps" in out
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--model", "2"])
    assert "ROADMAP A16" in capsys.readouterr().err


def test_train_lm_example_runs(tmp_path):
    out = _run([str(ROOT / "examples" / "torch_port" / "train_lm.py"),
                "--steps", "2", "--batch", "2", "--seq", "32",
                "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert "done in" in out and "loss" in out
    assert ckpt.latest_step(str(tmp_path)) == 2


# --------------------------------------------------------------------- #
# serving a trained model records no autograd graph
# --------------------------------------------------------------------- #
SERVE_MODES = {
    "eager": ("qwen3-4b", {}),
    "fused": ("qwen3-4b", {"fused": True}),
    "cascade": ("qwen3-4b", {"fused": True, "cascade": True,
                             "prefill_chunk": 16}),
    "speculative": ("qwen3-4b", {"speculative": True}),
    "mesh-2x1": ("qwen3-4b", {"fused": True, "mesh": "2x1"}),
    "mamba2-fused": ("mamba2-2.7b", {"fused": True}),
}


@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_serving_trained_weights_records_no_graph(mode):
    """After a train step the weights require gradients; the engine's
    every path (admission and prefill, eager, fused, cascade, speculative
    and mesh decode, the Mamba state) must still record no autograd graph:
    no tensor is saved for a backward pass, no pool or state requires
    grad, and the streams equal a serve of the same weights detached."""
    from repro_torch.distributed import decode_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving.engine import DecodeEngine
    arch, kw = SERVE_MODES[mode]
    cfg = smoke_config(arch)
    opt = O.adamw(O.cosine_schedule(LR, 2, 10))
    st = Tr.init_state(cfg, opt, torch.Generator().manual_seed(1),
                       device="cpu")
    rng = np.random.default_rng(2)
    st, _ = Tr.make_train_step(cfg, opt)(st, tuple(
        torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
        for _ in range(2)))
    assert all(p.requires_grad for p in st.params.values())
    doc = rng.integers(1, cfg.vocab_size, 40).tolist()
    prompts = [doc + rng.integers(1, cfg.vocab_size, 5).tolist()
               for _ in range(3)]

    def serve(model):
        args = dict(kw)
        if args.pop("mesh", None):
            args["mesh"] = decode_mesh(2, 1, device="cpu")
            args["seq_split_pages"] = 2
        eng = DecodeEngine(cfg, model, page_size=8, num_pages=128, max_q=8,
                           device="cpu", **args)
        for p in prompts:
            eng.add_request(p, max_new=6)
        out = eng.run(32)
        return eng, out

    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.shape) or t, lambda t: t):
        eng, got = serve(st.model)
    assert not saved, saved[:5]
    pools = [t for t in vars(eng.pool).values() if torch.is_tensor(t)]
    assert pools and not any(t.requires_grad for t in pools)
    detached = Transformer.from_state_dict(
        cfg, {k: v.detach().clone() for k, v in st.params.items()})
    _, want = serve(detached)
    assert got == want


def test_prefill_and_serve_steps(qwen):
    """``make_prefill_step`` gives ``repro``'s last-position logits; one
    ``make_serve_step`` after a dense prefill gives the full forward's
    logits at the next position."""
    from repro_torch.models.transformer import prefill
    st = qwen.state(_optimizers(qwen.name)[1])
    toks = qwen.tokens[:, :12]
    want = jax.jit(JTr.make_prefill_step(qwen.jcfg))(qwen.jparams,
                                                     jnp.asarray(toks))
    got = Tr.make_prefill_step(qwen.cfg)(st.model, torch.from_numpy(toks))
    assert got.shape == (B, 1, qwen.cfg.vocab_size) and got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    _, cache, clen = prefill(st.model, torch.from_numpy(toks[:, :11]), 16)
    logits, _, clen2 = Tr.make_serve_step(qwen.cfg)(
        st.model, torch.from_numpy(toks[:, 11:12]), cache, clen)
    assert torch.equal(clen2, clen + 1) and logits.grad_fn is None
    np.testing.assert_allclose(logits.numpy(), got[:, 0].numpy(),
                               rtol=1e-4, atol=1e-4)
