"""The port's sharded serving against the JAX package's, on the CPU.

* **The plan**, held against the reference's objects (which need no
  devices): ``validate`` names the offender and refuses bad modes and
  format typos with the reference's messages; ``make_plan`` honours
  ``REPRO_SHARD_COMPRESS``; ``step_interconnect_bytes`` equals the
  reference's for gather and psum, tp 2/4, dp 2, uncompressed and
  takum16, at the reduced and the full phi3-medium-14b;
  ``shard_pool_bytes`` divides by tp; ``describe`` and every leaf's
  placement (``leaf_spec``) equal the reference's.
* **Serving parity**, one 4-rank gloo job
  (``repro_torch.serve.shard_selftest``) at ``serve_cfg()`` (reduced phi3,
  16/8 heads, takum8 pages, page 8, decode batch 4, prompts 12/5/9/17,
  8 new) with the reference's ``model.init(PRNGKey(0))`` weights carried
  across: gather mode at tp 1, 2 and 4 and dp 2 x tp 2 and psum at tp 2,
  greedy tokens equal to the **JAX engine's single-device tokens**, and
  to the port's single-rank engine's (at tp 2 ``generate_lockstep``'s
  too); seeded sampling (temperature 0.8,
  top_p 0.9, seeds 123 + i) and ``PagePool.stats()`` equal to the port's
  single-rank run; the reference's takum8 wire weights at tp 2, tokens
  equal to the JAX engine's on them (the ``WireMatrix`` column slices),
  and the port's lns-takum8 words of the same weights at tp 2 equal to
  the port's single-rank tokens (the LNS matmul);
  takum16-compressed collectives at tp 2 with finite, non-zero residuals
  and their gauges; reduced granite-moe at tp 2 equal to the port's
  single-rank tokens (the reference's tp 2 tokens equal its
  single-device ones). Tokens must be equal; one prefill chunk's logits
  in gather mode within 1e-5 of the single-rank engine's
  (``shard_selftest.LOGITS_TOL``; bit-equal on this host).
* Without a process group a multi-rank plan raises, naming how to
  launch; ``python -m repro_torch.serve.shard_selftest --world 4`` prints
  ``SHARD SELFTEST OK``.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.kernels.ops import WireMatrix as JWireMatrix
from repro.models import model as jmodel
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import quantize_weights as jquantize
from repro.serve.paged import PagePool as JPagePool
from repro.serve.shard import ShardPlan as JShardPlan
from repro.serve.shard import make_plan as jmake_plan
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.serve import shard_selftest as sst
from repro_torch.serve.engine import quantize_weights
from repro_torch.serve.paged import PagePool
from repro_torch.serve.shard import ShardPlan, make_plan

ROOT = Path(__file__).resolve().parents[1]
PLANS = [dict(tp=t, dp=d, mode=m, compress=c)
         for t in (1, 2, 4) for d in (1, 2) for m in ("gather", "psum")
         for c in (None, "takum16", "takum8")]


def _jcfg(arch="phi3-medium-14b"):
    cfg = jget_arch(arch).reduced
    if arch == "phi3-medium-14b":
        cfg = dataclasses.replace(cfg, n_heads=16, n_kv_heads=8)
    return dataclasses.replace(cfg, kv_quant="takum8")


def _raises_alike(fn, jfn):
    with pytest.raises(ValueError) as want:
        jfn()
    with pytest.raises(ValueError) as got:
        fn()
    assert str(got.value) == str(want.value)


# -- the plan -------------------------------------------------------------------


def test_plan_validate_names_the_offender():
    cfg, jcfg = sst.serve_cfg(), _jcfg()
    ShardPlan(tp=4).validate(cfg)   # 16 / 8 / 192 all divide 4
    _raises_alike(lambda: ShardPlan(tp=16).validate(cfg),
                  lambda: JShardPlan(tp=16).validate(jcfg))
    _raises_alike(lambda: ShardPlan(tp=2, mode="allreduce"),
                  lambda: JShardPlan(tp=2, mode="allreduce"))
    _raises_alike(lambda: ShardPlan(tp=0), lambda: JShardPlan(tp=0))
    with pytest.raises(ValueError, match="unknown format"):
        ShardPlan(tp=2, compress="takum999x")
    with pytest.raises(ValueError, match="identity"):
        ShardPlan(tp=2, compress="none")
    for bad in ("takum999x", "none"):
        with pytest.raises(ValueError):
            JShardPlan(tp=2, compress=bad)


def test_make_plan_env_override():
    for env in ({}, {"REPRO_SHARD_COMPRESS": "0"},
                {"REPRO_SHARD_COMPRESS": "off"},
                {"REPRO_SHARD_COMPRESS": "none"}, {"REPRO_SHARD_COMPRESS": ""},
                {"REPRO_SHARD_COMPRESS": " takum8 "}):
        for compress in (None, "takum16"):
            got = make_plan(tp=2, compress=compress, env=env)
            want = jmake_plan(tp=2, compress=compress, env=env)
            assert got.compress == want.compress, (env, compress)
    assert make_plan(tp=2, compress=None,
                     env={"REPRO_SHARD_COMPRESS": "takum8"}).compress \
        == "takum8"


@pytest.mark.parametrize("arch_cfg", ["reduced", "full"])
def test_step_interconnect_bytes_and_describe_equal_the_reference(arch_cfg):
    if arch_cfg == "reduced":
        cfg, jcfg = sst.serve_cfg(), _jcfg()
    else:
        cfg = get_arch("phi3-medium-14b").config
        jcfg = jget_arch("phi3-medium-14b").config
    for kw in PLANS:
        for batch in (1, 4, 6):
            got = ShardPlan(**kw).step_interconnect_bytes(cfg, batch)
            assert got == JShardPlan(**kw).step_interconnect_bytes(
                jcfg, batch), (kw, batch)
        assert ShardPlan(**kw).describe(cfg, 4) == \
            JShardPlan(**kw).describe(jcfg, 4)
        assert ShardPlan(**kw).describe() == JShardPlan(**kw).describe()
    if arch_cfg == "full":
        # 40 layers x 4 rows x (40 * 128 + 17920) columns x 4 bytes
        assert ShardPlan(tp=2).step_interconnect_bytes(cfg, 4) == 14_745_600
        assert ShardPlan(tp=2, compress="takum16").step_interconnect_bytes(
            cfg, 4) == 14_745_600 // 2


def test_pool_shard_bytes_divides_by_tp():
    cfg, jcfg = sst.serve_cfg(), _jcfg()
    pool = PagePool(cfg, batch=4, num_pages=17, page_size=8, max_pages=4,
                    alloc_device=False)
    jpool = JPagePool(jcfg, batch=4, num_pages=17, page_size=8,
                      max_pages=4, alloc_device=False)
    assert pool.hbm_bytes() == jpool.hbm_bytes()
    for tp in (1, 2, 4):
        assert ShardPlan(tp=tp).shard_pool_bytes(pool) == \
            JShardPlan(tp=tp).shard_pool_bytes(jpool) == \
            pool.hbm_bytes() // tp


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tuple(tree.shape)


def test_leaf_spec_equals_the_reference():
    for arch in ("phi3-medium-14b", "granite-moe-3b-a800m"):
        shapes = jax.eval_shape(lambda a=arch: jmodel.init(
            jax.random.PRNGKey(0), _jcfg(a)))
        leaves = list(_leaves(shapes))
        assert any(n.endswith("wq") for n, _ in leaves)
        for kw in PLANS:
            plan, jplan = ShardPlan(**kw), JShardPlan(**kw)
            for name, shape in leaves:
                assert plan.leaf_spec(name, shape) == tuple(
                    jplan.leaf_spec(name, shape)), (kw, name)


def test_plan_without_a_process_group_names_the_launch():
    with pytest.raises(ValueError, match="init_process_group") as ei:
        ShardPlan(tp=2).build_mesh()
    assert "shard_selftest --world" in str(ei.value)


# -- serving parity -------------------------------------------------------------


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda leaf: ((np.asarray(leaf.words), leaf.spec.name)
                      if isinstance(leaf, JWireMatrix) else np.asarray(leaf)),
        tree, is_leaf=lambda leaf: isinstance(leaf, JWireMatrix))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The reference's weights (float, takum8 wire, reduced granite-moe)
    carried across; the 4-rank job on them (in a thread: the ranks are
    processes) while the JAX engine serves the float and the wire weights
    on one device: (weights, the job's results, the JAX tokens, the
    output of ``python -m repro_torch.serve.shard_selftest --world 4``,
    run meanwhile as a subprocess)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.shard_selftest",
         "--world", "4"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    jcfg = _jcfg()
    init = jax.jit(jmodel.init, static_argnums=1)
    jp = init(jax.random.PRNGKey(0), jcfg)
    jw = jax.jit(lambda p: jquantize(p, "takum8", mode="wire",
                                     verbose=False))(jp)
    jm = init(jax.random.PRNGKey(0), _jcfg(sst.MOE_ARCH))
    cfg = sst.serve_cfg()
    weights = {"float": params_from_numpy(_to_numpy(jp), cfg, "cpu"),
               "takum8": params_from_numpy(_to_numpy(jw), cfg, "cpu"),
               "moe": params_from_numpy(_to_numpy(jm),
                                        sst.serve_cfg(sst.MOE_ARCH), "cpu")}
    # the port's LNS words of the same weights (the reference's differ by
    # neighbour words: tests/test_torch_lns_serve.py)
    weights["lns-takum8"] = quantize_weights(weights["float"], "lns-takum8",
                                             mode="wire", verbose=False)
    job = {}

    def run():
        try:
            job["results"] = sst.run_job(
                4, weights, str(tmp_path_factory.mktemp("job")))
        except Exception as e:     # re-raised in the test's thread below
            job["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    toks = sst.prompts(cfg)
    jwant = {}
    try:
        for key, params in (("greedy", jp), ("wire", jw)):
            eng = JServeEngine(params, jcfg, max_len=sst.MAX_LEN,
                               page_size=8, decode_batch=4)
            jwant[key] = eng.generate(toks, sst.MAX_NEW)
            if key == "greedy":
                jwant["stats"] = dataclasses.asdict(
                    eng.scheduler().pool.stats())
    finally:
        thread.join(timeout=600)
        try:
            out, err = cli.communicate(timeout=600)
        finally:
            cli.kill()
    assert not thread.is_alive(), "the 4-rank job did not end"
    if "error" in job:
        raise job["error"]
    return weights, job["results"], jwant, (cli.returncode, out, err)


def test_sharded_serving_equals_the_reference(served):
    weights, results, jwant, _ = served
    assert set(results) == set(sst.CASES)
    # the port's single-rank engine (a plan of one rank) against the JAX
    # engine, then every sharded case against the single-rank engine
    want = sst.single_rank(weights, list(results))
    assert want["greedy"] == jwant["greedy"]
    assert want["stats"] == jwant["stats"]
    assert want["takum8"] == jwant["wire"]
    lines = sst.check(results, want)
    assert len(lines) == len(sst.CASES)
    for name in ("tp4", "tp2", "dp2tp2", "psum2"):
        assert results[name][0]["greedy"] == jwant["greedy"], name
    assert results["wire2"][0]["greedy"] == jwant["wire"]
    # the residual gauges: one a layer and site on each rank
    n_layers = sst.serve_cfg().n_layers
    for rank in results["takum16"]:
        assert len(rank["norms"]) == 2 * n_layers
        assert len(rank["gauges"]) == 2 * n_layers


def test_shard_selftest_cli(served):
    code, out, err = served[3]
    assert code == 0, out + err[-4000:]
    assert "SHARD SELFTEST OK" in out
