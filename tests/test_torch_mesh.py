"""The jet split over devices (`parallel.mesh`, `variational_mt_sharded` and
the stage-2 CLI's branch) on the CPU, where a mesh of two CPU entries runs
two shards on two host threads.

Jets share nothing, so a split batch must give exactly the batched result:
`variational_mt_sharded` and `sharded_jet_step` on [cpu, cpu] are bit-equal
to `variational_mt_batched` / `compute_one_level` over the whole batch (as
tests/test_mesh.py demands of the JAX package), and the stage-2 CLI with
`devices=[cpu, cpu]` writes the same `.flo` bytes as with one device.
Meshes that cannot be honoured raise: a batch that does not split evenly, a
device torch cannot see, an sp mesh given to the jet-only pyramid (an sp
mesh itself is built: tests/test_torch_sp.py runs it).
The `cuda` case runs two shards on one card; there the kernels' band plans
depend on the local batch, so it is held to chip_smoke's slice tolerances.
"""
import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

from slowflow_tpu_torch.bench_scene import moving_sequence
from slowflow_tpu_torch.cli import slow_flow
from slowflow_tpu_torch.parallel import mesh as pmesh
from slowflow_tpu_torch.variational.multiframe import (
    compute_one_level, variational_mt_batched, variational_mt_sharded)
from slowflow_tpu_torch.variational.params import MultiFrameParams
from test_torch_cli_epic import _sequence

CPU2 = ["cpu", "cpu"]
P = MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0), layers=2,
                     niter_alter=2, niter_outer=2, niter_solver=8,
                     occlusion_reasoning=True, smoothing=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b=4, h=24, w=32, seed=0):
    """b normalized windows of the bench scene (S = 3) at other motions,
    and a small random initial flow."""
    rng = np.random.default_rng(seed)
    seq = np.stack([moving_sequence(5, h, w, 1.0 + 0.2 * i, -0.5, seed=i)
                    for i in range(b)]).astype(np.float32)
    seq = (seq - seq.mean()) / seq.std()
    wx = (rng.normal(size=(b, h, w)) * 0.1).astype(np.float32)
    wy = (rng.normal(size=(b, h, w)) * 0.1).astype(np.float32)
    cw = np.ones((b, 3, h, w), np.float32)
    na = np.zeros((b, 3), np.float32)
    ns = np.ones((b, 3), np.float32)
    return [torch.as_tensor(a) for a in (wx, wy, seq, cw, na, ns)]


def _equal(got, want):
    for g, w, name in zip(got, want, ("wx", "wy", "occ")):
        assert torch.equal(g, w), (name, (g - w).abs().max().item())


def test_sharded_matches_batched_bitwise():
    wx, wy, seq, cw, na, ns = _inputs()
    want = variational_mt_batched(wx, wy, seq, P, cw, na, ns, device="cpu")
    got = variational_mt_sharded(wx, wy, seq, P, CPU2, cw, na, ns)
    _equal(got, want)
    assert all(t.device.type == "cpu" for t in got)
    # defaults for the terms, and four shards of one jet
    _equal(variational_mt_sharded(wx, wy, seq, P, ["cpu"] * 4),
           variational_mt_batched(wx, wy, seq, P, device="cpu"))


def test_sharded_jet_step_matches_one_level():
    args = _inputs()
    want = compute_one_level(*args, p=P)
    got = pmesh.sharded_jet_step(pmesh.make_mesh(devices=CPU2), P)(*args)
    _equal(got, want)


def test_shard_jet_batch_is_contiguous():
    x = torch.arange(12.0).reshape(6, 2)
    y = torch.arange(6)
    shards = pmesh.shard_jet_batch(["cpu"] * 3, x, y)
    assert len(shards) == 3
    for i, (xs, ys) in enumerate(shards):
        assert torch.equal(xs, x[2 * i:2 * i + 2])
        assert torch.equal(ys, y[2 * i:2 * i + 2])


def test_meshes_that_cannot_be_honoured_raise():
    wx, wy, seq, *_ = _inputs(b=3, h=16, w=20)
    with pytest.raises(ValueError, match="does not split evenly"):
        variational_mt_sharded(wx, wy, seq, P, CPU2)
    with pytest.raises(ValueError, match="does not split evenly"):
        pmesh.shard_jet_batch(CPU2, wx)
    sp = pmesh.make_mesh(n_jet=1, n_sp=2, devices=CPU2)
    assert sp.shape == {"jet": 1, "sp": 2} and list(sp) == [
        torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="sp extent 1"):
        variational_mt_sharded(wx[:2], wy[:2], seq[:2], P, sp)
    with pytest.raises(ValueError, match="n_jet"):
        pmesh.make_mesh(n_jet=3, devices=CPU2)
    with mock.patch("torch.cuda.is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no GPU"):
            pmesh.make_mesh()
        with pytest.raises(RuntimeError, match="no GPU"):
            variational_mt_sharded(wx[:2], wy[:2], seq[:2], P,
                                   ["cpu", "cuda:0"])
    with mock.patch("torch.cuda.is_available", return_value=True), \
            mock.patch("torch.cuda.device_count", return_value=1):
        with pytest.raises(RuntimeError, match="sees 1 CUDA"):
            pmesh.make_mesh(devices=["cuda:0", "cuda:1"])


def _cfg(path, seq_dir, out):
    path.write_text(textwrap.dedent(f"""\
    file\t{seq_dir}/frame_%03i.png
    output\t{out}
    Jets\t4
    start\t2
    max_fps\t40
    ref_fps\t20
    jet_fps\t40
    adaptive\t0
    16bit\t0
    raw\t0
    scale\t1.0
    deep_matching\t0
    slow_flow_S\t3
    slow_flow_layers\t2
    slow_flow_p_scale\t0.8
    slow_flow_occlusion_reasoning\t1
    slow_flow_niter_alter\t2
    slow_flow_niter_outer\t2
    slow_flow_niter_solver\t5
    """))
    return path


def test_cli_split_writes_the_same_flo_bytes(tmp_path):
    """Jets 4 at -batch 4: one group of 4 per direction, split into two
    shards of 2 with devices=[cpu, cpu]; the same .flo bytes as one
    device. The sharded branch must be the one taken."""
    seq_dir = _sequence(tmp_path / "seq", h=32, w=40, n=16)
    outs = {}
    for name, devices in (("one", None), ("two", CPU2)):
        cfg = _cfg(tmp_path / f"{name}.cfg", seq_dir, tmp_path / name)
        with mock.patch.object(slow_flow, "variational_mt_sharded",
                               wraps=variational_mt_sharded) as sharded:
            assert slow_flow.run(str(cfg), batch=4, device="cpu",
                                 devices=devices) == 0
        assert sharded.call_count == (2 if devices else 0)
        outs[name] = {p.name: p.read_bytes()
                      for p in sorted((tmp_path / name).glob("*.flo"))}
    assert len(outs["one"]) == 8
    assert outs["one"] == outs["two"]


@pytest.mark.cuda
def test_two_shards_on_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from slowflow_tpu_torch import kernels

    args = [a.cuda() for a in _inputs(b=4, h=48, w=64)]
    want = variational_mt_batched(*args[:3], P, *args[3:])
    kernels.reset_launch_counts()
    got = variational_mt_sharded(*args[:3], P, ["cuda:0", "cuda:0"],
                                 *args[3:])
    assert kernels.LAUNCHES["solve_step"] > 0
    assert kernels.LAUNCHES["warp_assemble"] > 0
    assert all(t.device == torch.device("cuda:0") for t in got)
    d = (got[0] - want[0]).abs()
    assert d.median().item() <= 1e-3 and d.mean().item() <= 1e-2
    assert (got[2] != want[2]).float().mean().item() <= 0.01
