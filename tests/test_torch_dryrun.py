"""The port's dry run (``launch.dryrun``), mesh and sharding context, on the
CPU.

Rank 0's program on a ``fake`` world of 256 ranks (16 x 16), at reduced
widths (2-3 layers, d_model 128; the cells' shapes as published) so each
cell runs in seconds: status ok for each of the five dense and vlm configs,
with arguments equal to the spec-based count (``dryrun.argument_bytes``,
which ``tests/test_torch_sharding.py`` holds against the reference at full
size) and a peak no lower than them; a (d x f) product split 16 ways over
`model` counts 1/16 of its FLOPs (``FlopCounterMode`` above DTensor counts
the whole product); the deferred configs raise ``ValueError`` before a
process group opens; no process group outlives a cell, one that fails
included; ``--execute`` on the CPU reads the dry run's arguments, FLOPs and
collective counts; ``--execute`` without CUDA refuses to fall back.
"""
import json

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (data_axis_size, fake_world,
                                     make_production_mesh, model_axis_size)
from repro_torch.models import shardctx
from repro_torch.models.params import P, shard_like

# one cell per config, every kind and the ring cache among them
CELLS = [("smollm_360m", "train_4k"), ("h2o_danube_1_8b", "long_500k"),
         ("phi3_medium_14b", "prefill_32k"), ("qwen3_8b", "decode_32k"),
         ("llava_next_34b", "train_4k")]
DEFERRED = [a for a in ARCH_IDS if get_config(a).family not in ("dense", "vlm")]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_reduced_cell_runs(arch, shape, tmp_path):
    cfg = get_config(arch).reduced()
    rec = dryrun.run_cell(arch, shape, False, str(tmp_path), cfg_override=cfg,
                          verbose=False)
    assert rec["status"] == "ok" and rec["mesh_device"] == "cpu"
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == dryrun.argument_bytes(
        cfg, arch, shape, False)
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"]
    assert rec["flops_per_device"] > 0 and rec["collective_counts"]
    assert rec["cost_method"] == "full-depth execution on the meta device"
    saved = json.loads((tmp_path / f"{arch}__{shape}__16x16.json").read_text())
    assert saved["memory_analysis"] == mem


def test_skipped_cell_is_recorded(tmp_path):
    rec = dryrun.run_cell("qwen3_8b", "long_500k", False, str(tmp_path),
                          verbose=False)
    assert rec["status"] == "skipped" and "500k" in rec["reason"]


@pytest.mark.parametrize("arch", DEFERRED)
def test_deferred_configs_raise(arch, tmp_path):
    assert len(DEFERRED) == 5
    with pytest.raises(ValueError, match="item 5b"):
        dryrun.run_cell(arch, "train_4k", False, str(tmp_path))


def test_main_fails_on_a_deferred_config(tmp_path, capsys):
    assert dryrun.main(["--arch", "mamba2_780m", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 1
    assert "FAILED" in capsys.readouterr().out


def test_sharded_matmul_counts_its_shard():
    """A (d x f) weight split 16 ways over `model`: the recorder counts
    1/16 of the product's FLOPs, FlopCounterMode above DTensor all of
    them."""
    n, d, f = 64, 256, 1024
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        x = DTensor.from_local(torch.empty(n, d, device="meta"), mesh,
                               [Replicate(), Replicate()])
        w = DTensor.from_local(torch.empty(d, f // 16, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        rec = dryrun.Recorder({})
        with rec:
            y = x @ w
        with FlopCounterMode(display=False) as fc:
            x @ w
    assert y.placements == (Replicate(), Shard(1))
    assert rec.flops * 16 == 2 * n * d * f == fc.get_total_flops()
    assert rec.collectives == {}


def test_policy_b_attention_runs_on_local_heads():
    """Policy B's attention (32 query heads split 16 ways over `model`, 8
    kv heads replicated, the batch over `data`): the recorder counts 1/256
    of the grouped products' FLOPs, forward and backward, no collective
    runs in the forward, and the output and q's gradient are laid out as
    q (each rank attends with its own 2 query heads and their kv head, as
    the reference's program; gathering the heads would count 1/16)."""
    from repro_torch.models import layers
    b, s, h, kv, hd = 16, 64, 32, 8, 8
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")

        def dt(shape, pls, dtype=torch.float32):
            return shard_like(torch.empty(shape, dtype=dtype, device="meta"),
                              mesh, pls)

        q = dt((b, s, h, hd), [Shard(0), Shard(2)]).requires_grad_()
        k = dt((b, s, kv, hd), [Shard(0), Replicate()]).requires_grad_()
        v = dt((b, s, kv, hd), [Shard(0), Replicate()]).requires_grad_()
        mask = dt((b, s, s), [Shard(0), Replicate()], torch.bool)
        rec = dryrun.Recorder({})
        with shardctx.ctx(mesh, ("data",)), rec:
            out = layers._sdpa(q, k, v, mask, kv)
            fwd, coll = rec.flops, dict(rec.collectives)
            out.sum().backward()
    product = 2 * b * h * s * s * hd             # one of the two einsums
    assert fwd * 256 == 2 * product and coll == {}
    assert rec.flops * 256 == 6 * product         # + 2 products per einsum
    assert out.placements == q.placements == q.grad.placements
    assert k.grad.shape == k.shape


def test_no_process_group_outlives_a_failed_cell(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(dryrun, "run_program", boom)
    with pytest.raises(RuntimeError, match="planted"):
        dryrun.run_cell("qwen3_8b", "decode_32k", False, str(tmp_path),
                        cfg_override=get_config("qwen3_8b").reduced())
    assert not dist.is_initialized()


def test_execute_on_the_cpu_reads_the_dry_run(tmp_path):
    cfg = get_config("qwen3_8b").reduced()
    rec = dryrun.run_cell("qwen3_8b", "decode_32k", False, str(tmp_path),
                          cfg_override=cfg, execute=True, device="cpu",
                          verbose=False)
    ex = rec["execute"]
    assert ex["device"] == "cpu" and ex["max_memory_allocated"] is None
    assert ex["argument_size_in_bytes"] == \
        rec["memory_analysis"]["argument_size_in_bytes"]
    assert ex["flops_per_device"] == rec["flops_per_device"]
    assert ex["collective_counts"] == rec["collective_counts"]


def test_execute_without_cuda_refuses(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.run_cell("qwen3_8b", "decode_32k", False, str(tmp_path),
                        execute=True)
    assert not dist.is_initialized()


def test_mesh_axis_sizes():
    for multi_pod, world, data in ((False, 256, 16), (True, 512, 32)):
        with fake_world(world):
            mesh = make_production_mesh(multi_pod, device_type="cpu")
            assert data_axis_size(mesh) == data
            assert model_axis_size(mesh) == 16
            with pytest.raises(RuntimeError, match="already open"):
                with fake_world(world):
                    pass


def test_constrain_is_the_identity_without_a_mesh_and_refuses_plain():
    x = torch.ones(4, 4)
    assert shardctx.mesh() is None and shardctx.batch_model_axes() is None
    assert shardctx.constrain(x, P("data", None)) is x
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        with shardctx.ctx(mesh, ("data",)):
            assert shardctx.batch_model_axes() == ("data", "model")
            with pytest.raises(TypeError, match="dropped"):
                shardctx.constrain(x, P("data", None))
            d = DTensor.from_local(torch.empty(4, 64, device="meta"), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            y = shardctx.constrain(d, P("data", "model"))
            assert y.placements == (Shard(0), Shard(1))
        assert shardctx.mesh() is None
