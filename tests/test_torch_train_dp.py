"""The port's manual data-parallel step against the JAX package's, on the CPU.

The reference's ``make_train_step_manual`` runs under ``jax.jit`` in one
child process over 4 forced host devices, on reduced phi3-medium-14b at
2 layers (T 32, a global batch of 4 ``SyntheticLM`` rows, three AdamW
steps from ``model.init(PRNGKey(0))``); the child also dumps, before each
step, its flat state and every rank's flat gradients (its ``_grads_fn``
on that rank's rows, ``flatten_like(pad_to=dp)``) and, from those, the
reduced chunk, the new error feedback and the norm through its own rings
in ``local_step``'s order. Meanwhile the port runs the same cases in one
4-rank gloo job (``repro_torch.train.dp_selftest``; two-rank cases side by
side, each in a process group of its own), then replays the reference's
gradients through ``trainer.reduce_flat_grads`` / ``apply_flat_grads``.

* **Replay**: the chunk and the new ``ef`` bit for bit; the norm within
  ``NORM_RTOL`` (an f32 sum of squares in XLA's order against the port's,
  rounded once from f64); ``m``, ``v`` (this rank's slice, placed by
  ``trainer.shard_slot``) and the parameters within ``ADAM_TOL`` of the
  magnitudes the update combined (``assert_update_close``: where an update
  cancels its inputs, one ulp of them is more than ``ADAM_TOL`` of the
  result), against the same lines of the reference's ``local_step`` run
  from the dumped gradients (its step computes them inside its own
  program, an ulp away from the dumped ones); the error feedback the
  reference's step carried on, bit for bit.
* **Free-running**, three steps from the same weights: losses within
  ``STEP_RTOL``, grad norms within ``GRAD_TOL``, every parameter leaf
  within ``STEP_RTOL`` relative L2 uncompressed. Compressed, two ranks'
  partial sums that cancel leave the sign of the sum to the takum16
  rounding, and the port's gradients are an ulp away from the
  reference's (another library's sums): where a word flips, AdamW moves
  that element by up to ``2 lr`` the other way. So a compressed run's
  leaves are held within ``WIRE_REL_L2``; its exactness is the
  replay's. (Between the port's own runs on the card and on the CPU the
  takum16 leaves agree within 1e-5: ``dp_selftest.against``.)
* Every rank's parameters bit for bit the same after every step; the
  bytes a rank sends a step equal ``trainer.step_interconnect_bytes``.
* dp 1 (no process group) equals ``make_train_step``; a model axis
  larger than 1 and a batch the ranks do not divide are refused by name
  before any hop; ``init_flat_state``'s shard and ``shard_slot``.

``tests/test_torch_train_dp_pod.py`` runs the pod case (pod 2 x data 2,
takum16 on the pod ring with error feedback) with these helpers.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import model as jmodel
from repro_torch.configs.base import RuntimeConfig
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data import pipeline as dp
from repro_torch.dist import collectives as coll
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.optim import adamw as opt
from repro_torch.train import dp_selftest as dst
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves
from test_torch_train import ADAM_TOL, GRAD_TOL, STEP_ATOL, STEP_RTOL

ROOT = Path(__file__).resolve().parents[1]
CASES = ("data2", "data2_takum16")
# the reference's f32 sum of squares against the port's, both then
# summed over two ranks and square-rooted
NORM_RTOL = 1e-6
# a compressed free-running leaf's relative L2 against the reference's
# (see the module docstring): a few words a step flipped by gradients an
# ulp apart, each moving its element by up to 2 lr the other way
WIRE_REL_L2 = 2e-3

# the reference's manual step and its per-rank gradients, in a child with
# 4 forced host devices (the test process keeps one)
REF_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_arch
from repro.configs.base import RuntimeConfig
from repro.core.quant import QuantSpec
from repro.data import pipeline as dp
from repro.dist import collectives as coll
from repro.models import model
from repro.optim import adamw as opt
from repro.train import trainer

LAYERS, T, B, STEPS, SEED, LR = map(float, sys.argv[2].split(","))
LAYERS, T, B, STEPS, SEED = int(LAYERS), int(T), int(B), int(STEPS), int(SEED)
cfg = dataclasses.replace(get_arch("phi3-medium-14b").reduced,
                          n_layers=LAYERS)
ocfg = opt.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
runtime = RuntimeConfig(remat="block")
ds = dp.SyntheticLM(cfg.vocab, T, B, seed=SEED)
params0 = model.init(jax.random.PRNGKey(0), cfg)
grads_of = jax.jit(trainer._grads_fn(cfg, runtime))


def probe_fn(mesh, compress):
    # local_step's lines after the gradients (the reference has no seam
    # there), from given flat gradients and state
    axes = mesh.axis_names
    has_pod = "pod" in axes and mesh.shape["pod"] > 1
    dpn = mesh.shape["data"]
    npod = mesh.shape["pod"] if "pod" in axes else 1
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)

    def local(g, ef, pflat, m, v, step_no):
        gflat = g[0]
        csize = gflat.size // dpn
        data_spec = None if has_pod else compress
        chunk, _ = coll.ring_reduce_scatter(gflat, "data", dpn,
                                            spec=data_spec, mean=False)
        ef_local = ef.reshape(csize)
        new_ef = jnp.zeros_like(ef_local)
        if has_pod:
            chunk = chunk + ef_local
            chunk, res = coll.ring_all_reduce(chunk, "pod", npod,
                                              spec=compress, mean=False)
            new_ef = res
        chunk = chunk / (dpn * npod)
        reduced = chunk
        rank = jax.lax.axis_index("data")
        p_slice = jax.lax.dynamic_slice(pflat, (rank * csize,), (csize,))
        gnorm = jnp.sqrt(jax.lax.psum(jnp.sum(chunk * chunk), "data"))
        scale = jnp.minimum(1.0, ocfg.clip_norm / jnp.maximum(gnorm, 1e-9))
        chunk = chunk * scale
        new_p, new_m, new_v = opt.flat_adamw_update(
            p_slice, chunk, m, v, step_no + 1, ocfg)
        pfull = coll.ring_all_gather(new_p, "data", dpn, spec=None)
        return (reduced[None], new_ef.reshape(1, 1, csize), gnorm[None],
                pfull, new_m, new_v)

    ef_spec = P("pod", "data", None) if "pod" in axes else P(None, "data",
                                                             None)
    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(dp_axes), ef_spec, P(), P("data"), P("data"), P()),
        out_specs=(P(dp_axes), ef_spec, P(dp_axes), P(), P("data"),
                   P("data")), check_vma=False))


out = {}
for case in sys.argv[3].split(","):
    name, shape, bits = case.split(":")
    shape = tuple(int(s) for s in shape.split("x"))
    n = int(np.prod(shape))
    axes = ("pod", "data", "model") if len(shape) == 2 else ("data", "model")
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape + (1,)), axes)
    dpn, npod = mesh.shape["data"], mesh.shape.get("pod", 1)
    spec = (None if bits == "none"
            else QuantSpec(fmt="takum", n=int(bits), scale="none"))
    state, fspec = trainer.init_flat_state(params0, dp=dpn, npod=npod)
    step = jax.jit(trainer.make_train_step_manual(
        cfg, ocfg, runtime, mesh, fspec, compress=spec))
    probe = probe_fn(mesh, spec)
    params, k = params0, B // n
    for s in range(STEPS + 1):
        pre = f"{name}/{s}/"
        out[pre + "params"] = np.asarray(opt.flatten_like(params)[0])
        for key in ("m", "v", "ef", "step"):
            out[pre + key] = np.asarray(getattr(state, key))
        if s == STEPS:
            break
        batch = {key: jnp.asarray(v) for key, v in ds.batch_at(s).items()}
        gf = np.stack([np.asarray(opt.flatten_like(grads_of(
            params, {key: v[i * k:(i + 1) * k] for key, v in batch.items()}
        )[2], pad_to=dpn)[0]) for i in range(n)])
        got = probe(jnp.asarray(gf), state.ef,
                    opt.flatten_like(params, pad_to=dpn)[0], state.m,
                    state.v, state.step)
        out[pre + "gflat"] = gf
        for key, v in zip(("chunk", "new_ef", "gnorm", "new_params",
                           "new_m", "new_v"), got):
            out[pre + key] = np.asarray(v)
        out[pre + "new_ef"] = out[pre + "new_ef"].reshape(n, -1)
        params, state, met = step(params, state, batch)
        for key, v in met.items():
            out[pre + "metric_" + key] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


def _case_arg(name):
    axes, comp = dst.CASES[name]
    shape = "x".join(str(s) for _, s in axes)
    return f"{name}:{shape}:{'none' if comp is None else comp[len('takum'):]}"


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def ref_params():
    """The reference's weights (PRNGKey 0) at the selftest's config."""
    cfg = dataclasses.replace(jget_arch("phi3-medium-14b").reduced,
                              n_layers=dst.LAYERS)
    return jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(0), cfg))


def run_cases(names, tmp_path) -> dict:
    """The reference's child and the port's jobs for ``names``: the
    reference's dumps, the port's free-running and replayed results."""
    out = tmp_path / "ref.npz"
    knobs = ",".join(str(x) for x in (dst.LAYERS, dst.SEQ, dst.BATCH,
                                      dst.STEPS, dst.SEED, dst.LR))
    child = subprocess.Popen(
        [sys.executable, "-c", REF_CHILD, str(out), knobs,
         ",".join(_case_arg(n) for n in names)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jp = ref_params()
    try:
        # meanwhile, the port's free-running cases from the same weights
        free_dir = tmp_path / "free"
        free_dir.mkdir()
        free = dst.run_job(4, {"params": params_from_numpy(
            jp, dst.train_cfg(), "cpu")}, str(free_dir), names=names)
        _, err = child.communicate(timeout=300)
    finally:
        child.kill()
    assert child.returncode == 0, err[-4000:]
    ref = dict(np.load(out))
    replay = {n: {"template": jp, "steps": [
        {k: ref[f"{n}/{s}/{k}"] for k in ("params", "m", "v", "ef", "step",
                                          "gflat")}
        for s in range(dst.STEPS)]} for n in names}
    replay_dir = tmp_path / "replay"
    replay_dir.mkdir()
    replayed = dst.run_job(4, {"params": None, "replay": replay},
                           str(replay_dir), names=names)
    return {"ref": ref, "free": free, "replay": replayed, "template": jp}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("dp"))


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


def assert_update_close(got, want, before, what, step=0.0):
    """``got`` within ``ADAM_TOL`` of the magnitudes the update combined,
    elementwise: ``|before| + |want|`` bounds each term of a moment's
    update; a parameter's also moves by ``lr * u``, whose ``u = m / (sqrt
    (v) + eps)`` is about 1 in size however its gradient cancels, so
    ``step`` (lr) joins them there."""
    bad = np.abs(got - want) > ADAM_TOL * (np.abs(before) + np.abs(want)
                                           + step)
    assert not bad.any(), (what, int(bad.sum()), got[bad][:4], want[bad][:4])


def _mesh_of(name, coords):
    """A rank's mesh of case ``name`` without its groups (for the slots)."""
    axes = dst.CASES[name][0]
    return Mesh(tuple(a for a, _ in axes), tuple(s for _, s in axes),
                tuple(coords[a] for a, _ in axes), (None,) * len(axes))


def _rank_index(name, coords):
    """The rank's row block of the global batch: (pod, data) row-major."""
    dpn = dict(dst.CASES[name][0])["data"]
    return coords["data"] + dpn * coords.get("pod", 0)


def check_replay_exact(runs, name):
    ref = runs["ref"]
    for r, rank in enumerate(runs["replay"][name]):
        i = _rank_index(name, rank["coords"])
        for s, got in enumerate(rank["replay"]):
            pre = f"{name}/{s}/"
            np.testing.assert_array_equal(
                _bits(got["chunk"]), _bits(ref[pre + "chunk"][i]),
                err_msg=f"{name} rank {r} step {s}: chunk")
            np.testing.assert_array_equal(
                _bits(got["new_ef"]), _bits(ref[pre + "new_ef"][i]),
                err_msg=f"{name} rank {r} step {s}: new ef")


def check_replay_update(runs, name):
    ref = runs["ref"]
    for r, rank in enumerate(runs["replay"][name]):
        i = _rank_index(name, rank["coords"])
        mesh = _mesh_of(name, rank["coords"])
        for s, got in enumerate(rank["replay"]):
            pre, nxt = f"{name}/{s}/", f"{name}/{s + 1}/"
            np.testing.assert_allclose(got["gnorm"], ref[pre + "gnorm"][i],
                                       rtol=NORM_RTOL)
            sl, (p, d) = trainer.shard_slot(mesh, ref[pre + "m"].size)
            for key in ("m", "v"):
                assert_update_close(got[key], ref[pre + "new_" + key][sl],
                                    ref[pre + key][sl], f"{name} {key}")
            g = ref[pre + "params"].size
            assert_update_close(got["params"], ref[pre + "new_params"][:g],
                                ref[pre + "params"], f"{name} params",
                                step=dst.LR)
            # the state the reference's step carried on: its ef exactly
            np.testing.assert_array_equal(_bits(got["ef"]),
                                          _bits(ref[nxt + "ef"][p, d]))


def check_free_running(runs, name, compressed):
    ref, ranks = runs["ref"], runs["free"][name]
    losses = [m["loss"] for m in ranks[0]["metrics"]]
    norms = [m["grad_norm"] for m in ranks[0]["metrics"]]
    steps = range(dst.STEPS)
    np.testing.assert_allclose(
        losses, [float(ref[f"{name}/{s}/metric_loss"]) for s in steps],
        rtol=STEP_RTOL)
    np.testing.assert_allclose(
        norms, [float(ref[f"{name}/{s}/metric_grad_norm"]) for s in steps],
        rtol=GRAD_TOL)
    want = opt.unflatten_like(torch.as_tensor(ref[f"{name}/{dst.STEPS}/"
                                                  "params"]),
                              opt.flat_spec(dst._torch_tree(
                                  runs["template"], "cpu")))
    got = params_to_numpy(dst._torch_tree(ranks[0]["params"], "cpu"),
                          dst.train_cfg())
    tol = WIRE_REL_L2 if compressed else STEP_RTOL
    for a, b in zip(jax.tree_util.tree_leaves(got), tree_leaves(want)):
        b = b.numpy()
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= tol, (name, a.shape, rel)


def check_ranks_and_bytes(runs, name):
    ranks = runs["free"][name]
    first = ranks[0]
    for r, rank in enumerate(ranks):
        for a, b in zip(tree_leaves(rank["params"]),
                        tree_leaves(first["params"])):
            np.testing.assert_array_equal(_bits(a), _bits(b),
                                          err_msg=f"{name} rank {r}")
        assert rank["fingerprints"] == first["fingerprints"]
        assert [m["loss"] for m in rank["metrics"]] == \
            [m["loss"] for m in first["metrics"]]
        assert rank["sent"] == [rank["census"]] * dst.STEPS, \
            (name, r, rank["sent"], rank["census"])


@pytest.mark.parametrize("name", CASES)
def test_replayed_chunk_and_error_feedback_are_bit_exact(runs, name):
    check_replay_exact(runs, name)


@pytest.mark.parametrize("name", CASES)
def test_replayed_norm_moments_and_parameters(runs, name):
    check_replay_update(runs, name)


@pytest.mark.parametrize("name", CASES)
def test_free_running_steps_match_the_reference(runs, name):
    check_free_running(runs, name, compressed=dst.CASES[name][1] is not None)


@pytest.mark.parametrize("name", CASES)
def test_ranks_agree_and_bytes_equal_the_census(runs, name):
    check_ranks_and_bytes(runs, name)


def test_census_counts_the_rings_hops():
    """At dp 2 takum16: a reduce-scatter hop of G/2 words at 2 bytes and
    the f32 all-gather of G/2, plus the norm's and the metrics' f32
    all-reduces (1 and 2 elements a hop, two hops each); at pod 2: the
    chunk's compressed all-reduce, 2 x G/2 words at 2 bytes, and the
    metrics over pod."""
    t16 = trainer.grad_spec_from_quant("takum16")
    g = 1000
    assert trainer.step_interconnect_bytes(g, 2, 1, t16) == \
        500 * 2 + 500 * 4 + 2 * 4 + 2 * 2 * 4
    assert trainer.step_interconnect_bytes(g, 2, 1, None) == \
        500 * 4 + 500 * 4 + 2 * 4 + 2 * 2 * 4
    assert trainer.step_interconnect_bytes(g, 1, 2, t16) == \
        2 * 500 * 2 + 2 * 2 * 4
    assert trainer.step_interconnect_bytes(g, 1, 1, t16) == 0
    assert coll.hop_bytes(trainer.grad_spec_from_quant("takum8")) == 1


def test_dp1_equals_the_single_device_step():
    """At dp 1 every ring is the identity: the manual step (a mesh of one
    rank, no process group) equals ``make_train_step`` within the step
    tolerances (flat AdamW runs the structured one's operations)."""
    cfg = dst.train_cfg()
    params = dst.make_params()
    mesh = make_mesh((1, 1), ("data", "model"))
    state, spec = trainer.init_flat_state(params, 1)
    step = trainer.make_train_step_manual(cfg, dst.opt_cfg(),
                                          RuntimeConfig(), mesh, spec)
    one = trainer.make_train_step(cfg, dst.opt_cfg(), RuntimeConfig())
    ds = dp.SyntheticLM(cfg.vocab, dst.SEQ, dst.BATCH, seed=dst.SEED)
    p1, p2, s2 = params, params, opt.init_state(params)
    for s in range(dst.STEPS):
        p1, state, m1 = step(p1, state, ds.batch_at(s))
        p2, s2, m2 = one(p2, s2, ds.batch_at(s))
        for k in ("loss", "xent", "aux"):
            np.testing.assert_allclose(float(m1[k]), float(m2[k]),
                                       rtol=STEP_RTOL)
        np.testing.assert_allclose(float(m1["grad_norm"]),
                                   float(m2["grad_norm"]), rtol=STEP_RTOL)
    assert int(state.step) == dst.STEPS
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=STEP_RTOL,
                                   atol=STEP_ATOL)
    # the single-pod error feedback is a zero that takes no memory
    assert not state.ef.any() and state.ef.stride() == (0,)


def _no_hops(monkeypatch):
    """Make any ring hop fail the test."""
    def hop(*a, **k):
        raise AssertionError("a hop ran before the refusal")
    monkeypatch.setattr(coll, "transport", hop)


def test_a_model_axis_is_refused_before_any_hop(monkeypatch):
    _no_hops(monkeypatch)
    mesh = Mesh(("data", "model"), (2, 2), (0, 0), (None, None))
    with pytest.raises(ValueError, match="model axis 1"):
        trainer.make_train_step_manual(dst.train_cfg(), dst.opt_cfg(),
                                       RuntimeConfig(), mesh, None)
    with pytest.raises(ValueError, match="'data' axis"):
        trainer.make_train_step_manual(dst.train_cfg(), dst.opt_cfg(),
                                       RuntimeConfig(), None, None)


def test_a_batch_the_ranks_do_not_divide_is_refused(monkeypatch):
    _no_hops(monkeypatch)
    params = dst.make_params()
    mesh = Mesh(("pod", "data", "model"), (2, 2, 1), (1, 0, 0),
                (None, None, None))
    state, spec = trainer.init_flat_state(params, 2, 2)
    step = trainer.make_train_step_manual(dst.train_cfg(), dst.opt_cfg(),
                                          RuntimeConfig(), mesh, spec)
    batch = dp.SyntheticLM(512, 8, 6, seed=0).batch_at(0)
    with pytest.raises(ValueError, match="global batch 6 is not divisible "
                                         "by the 4 data-parallel ranks"):
        step(params, state, batch)


def test_flat_state_shards_and_their_places():
    """``init_flat_state``: each rank's m, v and ef are G/dp zeros (ef a
    broadcast zero without a pod ring); ``shard_slot``/``state_shard``
    take rank (pod 1, data 1)'s pieces of the reference's layout."""
    params = dst.make_params()
    g = sum(p.numel() for p in tree_leaves(params))
    state, spec = trainer.init_flat_state(params, 2, 2)
    pad = (-g) % 2
    assert spec[4] == pad and state.m.shape == ((g + pad) // 2,)
    assert state.ef.stride() == (1,) and int(state.step) == 0
    flat = opt.flatten_like(params, pad_to=2)[0]
    assert torch.equal(opt.flat_slice(params, 7, 100), flat[7:107])
    assert torch.equal(opt.flat_slice(params, len(flat) - 3, 3), flat[-3:])
    mesh = Mesh(("pod", "data", "model"), (2, 2, 1), (1, 1, 0),
                (None, None, None))
    n = len(flat)
    m = np.arange(n, dtype=np.float32)
    ef = np.arange(n * 2, dtype=np.float32).reshape(2, 2, n // 2)
    sl, place = trainer.shard_slot(mesh, n)
    assert (sl.start, sl.stop, place) == (n // 2, n, (1, 1))
    st = trainer.state_shard(m, -m, ef, 3, mesh)
    assert np.array_equal(st.m.numpy(), m[n // 2:])
    assert np.array_equal(st.v.numpy(), -m[n // 2:])
    assert np.array_equal(st.ef.numpy(), ef[1, 1]) and int(st.step) == 3
