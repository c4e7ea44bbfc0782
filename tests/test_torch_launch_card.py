"""The launch tooling on the card (skipped without one): the launchers
launch the index kernels (K1 and K2 on the corpus's and the prefix
cache's index), and ``compressed_psum`` over a one-rank NCCL group equals
``compress_roundtrip`` bit for bit, on the card and against the CPU. No
JAX here: the card's results are held to the port's plain versions."""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve
from repro_torch.launch.train import main as train_main
from repro_torch.parallel import compression as comp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_compressed_psum_nccl_one_rank_is_the_roundtrip(cuda, tmp_path):
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1, device_id=cuda)
    try:
        x = torch.from_numpy(np.random.default_rng(17).normal(
            0, 3, (4096, 3)).astype(np.float32))
        got = comp.compressed_psum(x.to(cuda))
        assert torch.equal(got, comp.compress_roundtrip(x.to(cuda)))
        assert torch.equal(got.cpu(), comp.compress_roundtrip(x))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_launchers_on_cuda_launch_the_index_kernels(cuda, tmp_path):
    ops.reset_launch_counts()
    res = train_main(["--arch", "qwen3-moe-30b-a3b", "--steps", "2",
                      "--batch", "2", "--seq", "32", "--ckpt-dir",
                      str(tmp_path / "ck")])
    assert np.isfinite(res["losses"]).all()
    counts = ops.launch_counts()
    assert counts["fused_locate"] > 0 and counts["bmat_rank"] > 0
    ops.reset_launch_counts()
    out = serve(smoke_config("deepseek-7b"), requests=3, device=cuda)
    counts = ops.launch_counts()
    assert out["hits"] == 2 and counts["fused_locate"] > 0
