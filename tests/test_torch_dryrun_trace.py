"""Dry-run cells traced on fake tensors against the same steps run for
real (``repro_torch/launch/dryrun.py``).

* On a one-rank mesh at the reduced size (phi3-medium-14b: takum8 wire
  weights and KV words for serving, float weights for training), a fake
  trace's argument bytes equal the real tensors' bytes, its outputs have
  the real outputs' shapes and dtypes, and its flop count is the real
  run's on the CPU through the plain versions within 1% (the kernels'
  charged formulas against the plain versions' aten products). In the
  trace every kernel wrapper takes its fake branch: no launch, no plain
  version.
* On a 4-rank fake mesh, reduced dense and moe serve under
  ``ShardPlan(tp=2, dp=2)``: rank 0 holds the plan's shards, and the
  collective census (all-gathers, hops, bytes) is the seams' and the
  plan's; the manual data-parallel step over 4 ranks sends
  ``trainer.step_interconnect_bytes``.
* One full-width cell through the CLI gives ``status: ok``.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import SHAPES, RuntimeConfig, get_arch
from repro_torch.kernels import cost, lns_matmul, quantize, ref
from repro_torch.kernels import takum_attention, takum_codec, takum_matmul
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model
from repro_torch.models.layers import padded_vocab
from repro_torch.serve.engine import quantize_weights
from repro_torch.serve.shard import ShardPlan
from repro_torch.train import trainer

B, T = 2, 64
SERVE = {"reduced": True, "global_batch": B, "seq_len": T,
         "kv_quant": "takum8", "weight_wire": "takum8"}
TRAIN = {"reduced": True, "global_batch": B, "seq_len": T, "microbatch": 0}
WRAPPERS = (takum_codec.decode, takum_codec.encode, takum_codec.kv_append,
            quantize.fake_quant, takum_matmul.qmatmul, lns_matmul.lns_matmul,
            takum_attention.attention, takum_attention.paged_attention)
_PLAIN = ("decode_ref", "encode_ref", "kv_append_ref", "fake_quant_ref",
          "qmatmul_ref", "lns_matmul_plain", "attention_ref",
          "paged_attention_ref")


def _leaf_specs(tree):
    return [(tuple(t.shape), t.dtype) for _, t in dryrun._leaves(tree)
            if isinstance(t, torch.Tensor)]


def _real_step(shape_name, ov):
    """The cell's step built from real CPU tensors, run under a cost
    counter: (argument bytes, outputs, flops)."""
    cfg, shape = dryrun._cell_config("phi3-medium-14b", shape_name, ov)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, cfg, device="cpu")
    if ov.get("weight_wire"):
        params = quantize_weights(params, ov["weight_wire"], mode="wire",
                                  cfg=cfg, verbose=False)
    batch = specs.dummy_batch(cfg, B, T if shape.kind != "decode" else 1,
                              seed=0, kind=shape.kind, device="cpu")
    cache = None
    if shape.kind != "train":
        cache = model.init_cache(cfg, B, T + 64, device="cpu")
        if shape.kind == "decode":
            dryrun._set_pos(cache, T)
    runtime = RuntimeConfig(microbatch=0)
    fn, args = dryrun.port_step(cfg, shape, make_mesh((1, 1),
                                                      ("data", "model")),
                                params, batch, cache, "gspmd", runtime)
    arg_bytes = dryrun._tensor_bytes(args)
    counter = cost.CostCounter()
    with counter:
        out = fn(*args)
    return arg_bytes, out, counter


@pytest.mark.parametrize("shape_name,ov", [("decode_32k", SERVE),
                                           ("prefill_32k", SERVE),
                                           ("train_4k", TRAIN)])
def test_fake_trace_equals_the_real_step(shape_name, ov, monkeypatch):
    arg_bytes, out, counter = _real_step(shape_name, ov)
    launches = [f.launches for f in WRAPPERS]

    def plain(*a, **k):
        raise AssertionError("a fake input reached a plain version")
    with monkeypatch.context() as m:
        for name in _PLAIN:
            m.setattr(ref, name, plain)
        cell = dryrun.run_cell("phi3-medium-14b", shape_name, out_dir=None,
                               mesh_shape=(1,), overrides=ov, keep=True)
    assert cell["status"] == "ok", cell.get("traceback")
    assert [f.launches for f in WRAPPERS] == launches
    assert cell["port_argument_bytes"] == arg_bytes
    assert _leaf_specs(cell["_trace"]["out"]) == _leaf_specs(out)
    assert cell["flops"] == pytest.approx(counter.flops, rel=0.01)
    kernels = cell["kernels"]
    if shape_name == "train_4k":
        assert kernels == {}           # float weights: plain PyTorch ops
        return
    n = get_arch("phi3-medium-14b").reduced.n_layers
    assert kernels["kv_append"]["calls"] == n
    assert kernels["attention"]["calls"] == n
    assert kernels["qmatmul"]["calls"] == 7 * n


def _sharded_cell(arch, shape_name):
    ov = {"reduced": True, "global_batch": 4, "seq_len": T,
          "kv_quant": "takum8"}
    return dryrun.run_cell(arch, shape_name, out_dir=None, mesh_shape=(2, 2),
                           overrides=ov, keep=True)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "granite-moe-3b-a800m"])
def test_four_fake_ranks_serve_the_plan_s_shards(arch):
    cfg = get_arch(arch).reduced
    plan = ShardPlan(tp=2, dp=2)
    cell = _sharded_cell(arch, "decode_32k")
    assert cell["status"] == "ok", cell.get("traceback")
    assert cell["n_devices"] == 4
    params = cell["_trace"]["args"][0]
    # rank 0's shards: the plan's column slices, the rest whole
    gen = torch.Generator().manual_seed(0)
    whole = model.init(gen, cfg, device="cpu")
    for (path, got), (_, full) in zip(dryrun._leaves(params),
                                      dryrun._leaves(whole)):
        name = "/".join(str(p) for p in path)
        spec = plan.leaf_spec(name, tuple(full.shape))
        want = [s // 2 if a is not None else s
                for s, a in zip(full.shape, list(spec) + [None] * 4)]
        assert list(got.shape) == want, name
    # the seams' all-gathers: attention (and the dense MLP) a layer, one
    # over the data replicas for the logits
    lcfg = plan.local_cfg(cfg)
    per_layer = [lcfg.n_heads * lcfg.hd]
    if cfg.family == "dense":
        per_layer.append(cfg.d_ff // 2)
    census = cell["collectives"]
    assert census["all-gather"]["count"] == cfg.n_layers * len(per_layer) + 1
    assert census["all-reduce"]["count"] == 0
    vp = padded_vocab(cfg.vocab)
    want = (cfg.n_layers * sum(per_layer) * 4 + 4 // 2 * vp) * 4
    assert census["wire_bytes"] == want
    assert census["hops"] == cfg.n_layers * len(per_layer) + 1
    if cfg.family == "dense":
        # the plan's own census is the whole tensor ring's: tp ranks'
        assert plan.step_interconnect_bytes(cfg, 4) == \
            2 * cfg.n_layers * sum(per_layer) * 4 * 4 + 4 * vp * 4
    # the kernels ran at a rank's heads
    assert cell["kernels"]["attention"]["calls"] == cfg.n_layers


def test_four_fake_ranks_train_data_parallel():
    ov = {"reduced": True, "global_batch": 8, "seq_len": T, "microbatch": 0}
    cell = dryrun.run_cell("phi3-medium-14b", "train_4k", out_dir=None,
                           mesh_shape=(4, 1), dp_mode="manual", overrides=ov)
    assert cell["status"] == "ok", cell.get("traceback")
    cfg = get_arch("phi3-medium-14b").reduced
    n = get_arch("phi3-medium-14b").reduced.param_count()
    assert n > 0
    total = sum(t.numel() for _, t in dryrun._leaves(
        model.init(torch.Generator().manual_seed(0), cfg, device="cpu")))
    flat = total + (-total) % 4
    census = cell["collectives"]
    assert census["wire_bytes"] == trainer.step_interconnect_bytes(flat, 4)
    assert census["reduce-scatter"]["count"] == 1
    assert census["all-gather"]["count"] == 1
    assert census["all-reduce"]["count"] == 2     # the norm, the metrics
    # a model axis is the manual step's refusal
    cell = dryrun.run_cell("phi3-medium-14b", "train_4k", out_dir=None,
                           mesh_shape=(2, 2), dp_mode="manual", overrides=ov)
    assert cell["status"] == "error" and "model axis 1" in cell["error"]


def test_a_full_width_cli_cell(tmp_path, capsys):
    rc = dryrun.main(["--arch", "phi3-medium-14b", "--shape", "decode_32k",
                      "--mesh", "1", "--out", str(tmp_path)])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "dryrun: 1 ok, 0 skipped, 0 errors"
    cell = json.loads((tmp_path / "phi3-medium-14b__decode_32k__mesh1x1.json")
                      .read_text())
    assert cell["status"] == "ok" and cell["n_devices"] == 1
    cfg = get_arch("phi3-medium-14b").config
    assert cell["params"] == cfg.param_count()
    assert cell["kernels"]["attention"]["calls"] == cfg.n_layers
    assert cell["kernels"]["kv_append"]["calls"] == cfg.n_layers
    # at one rank the reference's placements hold every byte, its int32
    # positions (one a layer and the step's) beside the port's host ints
    assert cell["memory"]["argument_size_in_bytes"] == \
        cell["port_argument_bytes"] + 4 * (cfg.n_layers + 1)
    shape = SHAPES["decode_32k"]
    assert cell["memory"]["output_size_in_bytes"] > 0
    # the flops of the step: 2 a weight and token, the attention's 4 a
    # key and lane, the last row's unembed
    hd = cfg.hd
    attn = 4 * shape.global_batch * cfg.n_heads * (shape.seq_len + 64) \
        * hd * cfg.n_layers
    assert cell["kernels"]["attention"]["flops"] == attn
    assert dataclasses.is_dataclass(shape)
