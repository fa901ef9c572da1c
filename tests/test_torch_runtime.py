"""The port's entry points run on the card unless the caller asks for the
CPU: with torch seeing no GPU, the default device raises in
`resolve_device`, in the solve entries and in the stage-2 CLI, and only an
explicit CPU request (`device="cpu"`, `-device cpu`, CPU tensors) runs the
plain twins. `torch.cuda.is_available` is patched to False, so these tests
behave the same on a machine with a GPU."""
import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

from slowflow_tpu_torch.runtime import resolve_device
from slowflow_tpu_torch.variational import multiframe as tmf
from slowflow_tpu_torch.variational.params import MultiFrameParams

P = MultiFrameParams(S=2, layers=1, niter_alter=1, niter_outer=1,
                     niter_solver=2, occlusion_reasoning=False)


@pytest.fixture
def no_gpu():
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        yield


def _window(h=12, w=16):
    rng = np.random.default_rng(0)
    seq = (rng.random((1, 3, 3, h, w)) * 255).astype(np.float32)
    return np.zeros((1, h, w), np.float32), seq


def test_default_device_is_cuda_and_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device("cuda")


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")],
                         ids=["str", "device"])
def test_explicit_cpu_device(no_gpu, device):
    assert resolve_device(device) == torch.device("cpu")


@pytest.mark.parametrize("entry", ["batched", "single"])
def test_solve_entries_refuse_the_silent_cpu_fallback(no_gpu, entry):
    z, seq = _window()
    with pytest.raises(RuntimeError, match="no GPU"):
        if entry == "batched":
            tmf.variational_mt_batched(z, z, seq, P, device=None)
        else:
            tmf.variational_mt(z[0], z[0], seq[0], P)


def test_solve_entry_runs_on_an_explicit_cpu(no_gpu):
    z, seq = _window()
    wx, wy, occ = tmf.variational_mt_batched(z, z, seq, P, device="cpu")
    assert wx.device.type == "cpu" and wx.shape == (1, 12, 16)
    assert torch.isfinite(wx).all() and torch.isfinite(wy).all()
    # CPU tensors are the caller's choice of device too
    again = tmf.variational_mt_batched(torch.from_numpy(z), torch.from_numpy(z),
                                       torch.from_numpy(seq), P)
    for a, b in zip((wx, wy, occ), again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _cli_cfg(tmp_path):
    from PIL import Image

    seq_dir = tmp_path / "seq"
    seq_dir.mkdir()
    rng = np.random.default_rng(1)
    for f in range(5):
        Image.fromarray((rng.random((16, 20, 3)) * 255).astype(np.uint8)).save(
            seq_dir / f"frame_{f:03d}.png")
    cfg = tmp_path / "slow_flow.cfg"
    cfg.write_text(textwrap.dedent(f"""\
    file\t{seq_dir}/frame_%03i.png
    output\t{tmp_path}/sf_out
    Jets\t1
    start\t1
    max_fps\t20
    ref_fps\t20
    jet_fps\t20
    adaptive\t0
    16bit\t0
    raw\t0
    deep_matching\t0
    slow_flow_S\t2
    slow_flow_layers\t1
    slow_flow_occlusion_reasoning\t0
    slow_flow_niter_alter\t1
    slow_flow_niter_outer\t1
    slow_flow_niter_solver\t2
    """))
    return cfg


def test_cli_without_device_raises(no_gpu, tmp_path):
    from slowflow_tpu_torch.cli.slow_flow import main

    cfg = _cli_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="no GPU"):
        main([str(cfg)])
    assert not (tmp_path / "sf_out").exists()   # nothing ran


def test_cli_with_cpu_device_runs(no_gpu, tmp_path):
    from slowflow_tpu_torch.cli.slow_flow import main

    assert main([str(_cli_cfg(tmp_path)), "-device", "cpu"]) == 0
    assert (tmp_path / "sf_out" / "frame_001.flo").exists()


def test_load_frame_defaults_to_cuda(no_gpu, tmp_path):
    """The CLIs' frame loader resizes on `device`, which defaults to CUDA
    (it did default to the CPU); an explicit CPU device runs."""
    from slowflow_tpu_torch.cli.common import load_frame
    from slowflow_tpu_torch.config import ParameterList
    from slowflow_tpu_torch.io import write_image

    path = tmp_path / "f.png"
    write_image(path, np.full((8, 12, 3), 100.0))
    with pytest.raises(RuntimeError, match="no GPU"):
        load_frame(str(path), ParameterList(), 0.5)
    img = load_frame(str(path), ParameterList(), 0.5, device="cpu")
    assert img.shape == (3, 4, 6)
