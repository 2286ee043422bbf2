"""The training loop on the GSPMD trainer, on 8 gloo ranks on the CPU: a
(2, 4) ("data", "model") mesh under fsdp, checkpoints every 5 steps.

A run failing at step 10 and resumed gives the uninterrupted run's losses
(every step's arithmetic, collectives included, is the same on every run,
so to the bit), a checkpoint the (2, 4) run saved resumes on one rank (the
checkpoint holds global tensors), and the command line's ``--mesh single``
at a world of 8 refuses with the rank count it needs.
"""

import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_ranks import GSPMD_LR, gspmd_config, launch

from repro_torch.checkpoint.ckpt import available_steps
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.optim import adamw, wsd
from repro_torch.parallel.sharding import ShardingPlan
from repro_torch.train.loop import train

torch.set_num_threads(2)  # several test processes share the cores

SHAPE = ShapeSpec("loop", 32, 8, "train")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gspmd_loop")
    dirs = {"whole": str(tmp / "whole"), "run": str(tmp / "run")}
    return tmp, dirs, launch("gspmd_loop", 8, tmp / "ranks", {"dirs": dirs, "shape": SHAPE})


def test_failure_and_resume_give_the_uninterrupted_losses(run):
    _, dirs, ranks = run
    for res in ranks:
        assert res["failed_at"] == 10  # the last periodic checkpoint before the failure
        assert res["resumed_final"] == 12 and len(res["resumed"]) == 2  # steps 10, 11
        assert res["resumed"] == res["whole"][10:]
        assert res["whole"] == ranks[0]["whole"]
    assert all(np.isfinite(ranks[0]["whole"]))
    assert available_steps(dirs["whole"]) == [5, 10, 12]
    assert available_steps(dirs["run"]) == [5, 10, 12]


def test_a_checkpoint_of_the_2x4_mesh_resumes_on_one_rank(run):
    """The (2, 4) run's step-10 checkpoint, resumed by the loop on a (1, 1)
    mesh of one rank, gives that run's losses of steps 10 and 11."""
    tmp, dirs, ranks = run
    one = tmp / "one"
    shutil.copytree(dirs["whole"], one)
    shutil.rmtree(one / "step-00000012")
    assert not dist.is_initialized()
    res = train(gspmd_config("granite-8b"), SHAPE, adamw(wsd(GSPMD_LR, 12)),
                ShardingPlan(fsdp=True), make_test_mesh((1, 1)), total_steps=12,
                ckpt_dir=str(one), ckpt_every=5, log_every=100, logger=lambda *a: None,
                device="cpu")
    assert not dist.is_initialized()  # the loop left its one-rank group
    assert res.final_step == 12 and len(res.losses) == 2
    np.testing.assert_allclose(res.losses, ranks[0]["whole"][10:], rtol=1e-5)


def test_mesh_single_at_a_world_of_8_names_256_ranks(run):
    _, _, ranks = run
    for res in ranks:
        assert res["single"] is not None and "needs 256 ranks" in res["single"]
        assert "has 8" in res["single"]


@pytest.mark.parametrize("multi_pod,ranks", [(False, 256), (True, 512)])
def test_production_meshes_refuse_a_world_of_one(multi_pod, ranks):
    with pytest.raises(ValueError, match=f"needs {ranks} ranks; the process group has 1"):
        make_production_mesh(multi_pod=multi_pod)
