"""data parallelism over torch.distributed (`parallel/mesh.py` and the DDP
`TrainStep`): two real ranks, each a process of tests/torch_port_ranks.py on
a gloo group over a `file://` store, held against the JAX package's
`make_parallel_train_step` and `make_parallel_detect` on a 2-device mesh of
this process's virtual CPU devices, from the same `from_jax_params` weights
and batch, at the tiny f32 configuration of tests/test_parallel.py. The
ranks import no JAX; they run while this process compiles the JAX step.

Tolerances are tests/test_parallel.py's: losses rtol 2e-4 / atol 1e-5,
parameters rtol 2e-3 / atol 2e-5 (DDP's buckets and XLA's all-reduce sum
the gradients in other orders), detections rtol 1e-5 / atol 1e-6.
"""

import json
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _model_for
from detect_to_track_tpu import parallel as jparallel
from detect_to_track_tpu import trainer as jtrainer
from detect_to_track_tpu.config import Config as JaxConfig
from detect_to_track_tpu_torch import trainer
from detect_to_track_tpu_torch.anchors import build_anchors
from detect_to_track_tpu_torch.config import Config
from detect_to_track_tpu_torch.data.synthetic import SyntheticVIDManager
from detect_to_track_tpu_torch.models import DetectTrackModule
from detect_to_track_tpu_torch.models.convert import from_jax_params
from detect_to_track_tpu_torch.parallel import local_value, make_mesh, shard_batch
from tests.torch_port_ranks import spawn

# tests/test_parallel.py's configuration, on 2 ranks
DP = dict(
    N_CLASSES=4,
    BATCH_SIZE=4,
    INPUT_SHAPE=(32, 48),
    ANCHOR_AREAS=(0.05,),
    ANCHOR_ASPECT_RATIOS=(1.0, 2.0),
    MAX_LABELS=4,
    PRE_NMS_TOPK=16,
    MAX_ROIS=8,
    MAX_DETS=4,
    D_MAX=1,
    K=2,
    COMPUTE_DTYPE="float32",
    LOADER_WORKERS=1,
)
LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)


def _jax_state(tx, params):
    p = jax.tree_util.tree_map(jnp.asarray, params)
    return jtrainer.TrainState(params=p, opt_state=tx.init(p), step=jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """the ranks' results and the JAX references: one 2-rank run of
    tests/torch_port_ranks.py's `step` mode."""
    work = tmp_path_factory.mktemp("dp_step")
    cfg = Config(**DP, NUM_DEVICES=2)
    jcfg = JaxConfig(**DP)
    jmodel = _model_for(jcfg, corr_impl="xla")
    h, w = cfg.INPUT_SHAPE
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, h, w, 3), jnp.float32), jnp.full((2, cfg.MAX_ROIS, 4), 0.4, jnp.float32)
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    manager = SyntheticVIDManager(n_samples=4, image_hw=cfg.INPUT_SHAPE, n_classes=cfg.N_CLASSES, n_objects=2)
    batch = next(iter(trainer.BatchLoader(manager, 4, cfg, seed=0)))
    images = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (4, 2, h, w, 3)))
    anchors = np.asarray(build_anchors(cfg.fm_shape, cfg.ANCHOR_AREAS, cfg.ANCHOR_ASPECT_RATIOS))
    (work / "cfg.json").write_text(json.dumps(cfg.__dict__))
    torch.save(from_jax_params(params), work / "init.pt")
    torch.save({"batch": tuple(batch), "images": images, "anchors": anchors}, work / "inputs.pt")

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, "step", work)
        tx = jtrainer.make_optimizer(jcfg, params)
        mesh = jparallel.make_mesh(2)
        state, dtl = jparallel.make_parallel_train_step(jmodel, jcfg, tx, mesh)(
            jparallel.replicate(_jax_state(tx, params), mesh), jparallel.shard_batch(batch, mesh)
        )
        jdtl = jax.device_get(dtl)
        jax_step = (np.array([jdtl.o, jdtl.b_rpn, jdtl.c, jdtl.b_rcnn, jdtl.t], np.float32),
                    from_jax_params(jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))))
        jdet = jparallel.make_parallel_detect(jmodel, jcfg, mesh)(variables, jnp.asarray(images), jnp.asarray(anchors))
        jax_detect = [np.asarray(f, np.float32) for f in jax.device_get(jdet)]
        results = ranks.result()

    # the port's single-process step on the whole batch
    model = DetectTrackModule.from_config(Config(**DP), device="cpu")
    model.load_state_dict(from_jax_params(params))
    single = trainer.make_train_step(model, Config(**DP), trainer.make_optimizer(Config(**DP), model), device="cpu")
    single_losses = single(batch).vector()
    yield dict(ranks=results, jax_step=jax_step, jax_detect=jax_detect,
               single=(single_losses, dict(model.named_parameters())))
    shutil.rmtree(work, ignore_errors=True)


def _params_close(got, ref):
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[name]), err_msg=name, **PARAM_TOL)


def test_ranks_import_no_jax_and_agree_bitwise(run):
    r0, r1 = run["ranks"]
    assert r0["jax_modules"] == r1["jax_modules"] == []
    assert r0["mesh"] == (2, 0, 1, True) and r1["mesh"] == (2, 1, 1, True)
    for key in ("step", "accum", "skip", "detect"):
        assert r0[key]["digest"] == r1[key]["digest"], key
    for key in ("step", "accum"):
        torch.testing.assert_close(r0[key]["losses"], r1[key]["losses"], rtol=0, atol=0)


def test_two_rank_step_matches_jax_parallel_step(run):
    """(a) one step of 2 pairs per rank against JAX's 2-device SPMD step."""
    got = run["ranks"][0]["step"]
    ref_losses, ref_params = run["jax_step"]
    np.testing.assert_allclose(got["losses"].numpy(), ref_losses, **LOSS_TOL)
    _params_close(got["params"], ref_params)


def test_two_rank_step_matches_single_process_step(run):
    """(a) the same global batch in one process: the port's own step."""
    got = run["ranks"][0]["step"]
    losses, params = run["single"]
    np.testing.assert_allclose(got["losses"].numpy(), losses.numpy(), **LOSS_TOL)
    _params_close(got["params"], {n: p.detach().numpy() for n, p in params.items()})


def test_grad_accum_two_ranks_matches_unsplit(run):
    """(b) GRAD_ACCUM 2 (the first microbatch under no_sync) against the
    unsplit 2-rank step."""
    r0 = run["ranks"][0]
    np.testing.assert_allclose(r0["accum"]["losses"].numpy(), r0["step"]["losses"].numpy(), **LOSS_TOL)
    assert r0["accum"]["max_err"] <= 2e-5


def test_nan_skip_on_one_rank_skips_on_both(run):
    """(c) a non-finite batch on rank 1 only: the mean losses are
    non-finite on both ranks, and both keep their parameters, momentum and
    step counter; the next clean step goes on."""
    for r in run["ranks"]:
        skip = r["skip"]
        assert torch.isfinite(skip["clean"]).all() and torch.isfinite(skip["again"]).all()
        assert not torch.isfinite(skip["skipped"]).all()
        assert skip["steps"] == (1, 1, 2)
        assert skip["params_kept"] and skip["momentum_kept"] and skip["n_momentum"] > 0


def test_parallel_detect_matches_jax(run):
    """(d) make_parallel_detect: each rank detects its 2 pairs, the
    all-gather gives both ranks the 4-pair batch; against JAX's sharded
    detect."""
    for r in run["ranks"]:
        fields = r["detect"]["fields"]
        assert [tuple(f.shape) for f in fields] == [f.shape for f in run["jax_detect"]]
        for got, ref in zip(fields, run["jax_detect"]):
            np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-5, atol=1e-6)


def test_world_size_must_equal_num_devices(run):
    """(h) in a 2-rank group NUM_DEVICES 4 or 1 raises, and NUM_HOSTS must
    divide the world; one process with no group is a world of one."""
    for r in run["ranks"]:
        for key in ("mesh_error {'n_devices': 4}", "mesh_error {'n_devices': 1}"):
            assert r[key] is not None and "must equal the world size, 2" in r[key]
        assert "must divide the world size 2" in r["mesh_error {'n_devices': 2, 'n_hosts': 3}"]
    with pytest.raises(ValueError, match="NUM_DEVICES=2 must equal the world size, 1"):
        make_mesh(2)
    assert tuple(make_mesh(1)) == (1, 0, 1, False)


def test_shard_batch_and_loader_shards_split_the_host_batch():
    """the host's ranks split its batch in order: BatchLoader's shards and
    shard_batch give the same rows, and together the unsharded batch."""
    from detect_to_track_tpu_torch.parallel import Mesh

    cfg = Config(**DP)
    manager = SyntheticVIDManager(n_samples=8, image_hw=cfg.INPUT_SHAPE, n_classes=cfg.N_CLASSES)
    whole = next(iter(trainer.BatchLoader(manager, 4, cfg, seed=3)))
    for index in range(2):
        mesh = Mesh(world_size=2, rank=index, n_hosts=1, collective=False)
        part = next(iter(trainer.BatchLoader(manager, 4, cfg, seed=3, shard=(index, 2))))
        ref = shard_batch(whole, mesh)
        np.testing.assert_array_equal(part.images, ref.images)
        np.testing.assert_array_equal(part.images, whole.images[2 * index : 2 * index + 2])
        for a, b in zip(part.labels, ref.labels):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="must divide over the host's ranks"):
        trainer.BatchLoader(manager, 4, cfg, shard=(0, 3))
    assert local_value({"x": (torch.ones(2),)})["x"][0].tolist() == [1.0, 1.0]


def test_single_process_helpers(monkeypatch):
    """without a process group every collective helper is the identity and
    the barrier a no-op; a rank's device is its card unless the caller
    names one, and without a card the default raises."""
    from detect_to_track_tpu_torch.parallel import (
        any_over_ranks,
        barrier_sync,
        launched,
        mean_over_ranks,
        rank_device,
        replicate,
    )

    mesh = make_mesh()
    t = torch.tensor([1.0, 2.0])
    assert mean_over_ranks(t, mesh) is t and any_over_ranks(True, mesh, torch.device("cpu"))
    module = torch.nn.Linear(2, 2)
    assert replicate(module, mesh) is module
    barrier_sync("nothing to wait for")
    assert rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rank_device()
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not launched()
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert launched()
