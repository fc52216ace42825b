"""The port's data-parallel and sharded training against the JAX package, on
the CPU with gloo (``parallel/``, the cross-rank BatchNorm and cycle loss,
the optimiser's collectives, the drivers under ``torchrun``), and Gbase's
remat.

Ranks are separate processes (``torch_port_utils.launch_ranks``: the
environment ``torchrun`` gives, a free port, one torch thread each, a
timeout after which they are killed and the test fails). They run the
scripts of this file, which import only the port.

Tolerances:
  * ``fit_mesh_shape``, ``check_per_chip_batch`` and the sharding rule:
    equal to JAX's;
  * BatchNorm and ``cosine_loss`` at 2 ranks against one process on the
    whole batch, forward and gradient: 1e-6 (float32; the sums over ranks
    add the same terms in another order);
  * the stage-1 TINY 64x64 step at 2 ranks against JAX's single-device step
    on the same weights and global batch: JAX's own data-parallel test
    (``tests/test_train_smoke.py``): loss rtol 1e-5, parameters rtol 1e-4
    and atol 5 x lr (a near-zero gradient whose sign flips moves Adam's
    first update by 2 x lr); G's BatchNorm statistics 1e-4 absolute, as
    ``test_torch_port_train_base.py`` holds them;
  * a 2-rank checkpoint restored in one process, and remat against no
    remat: bit for bit.
"""

import json
import os
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import jax

from megaportraits_tpu.core import config as jconfig
from megaportraits_tpu.core.dtypes import FP32_POLICY as JP
from megaportraits_tpu.models.gbase import Gbase as JGbase
from megaportraits_tpu.parallel import mesh as jmesh
from megaportraits_tpu.parallel import sharding_rules as jrules
from megaportraits_tpu.train import train_base as jtb
from megaportraits_tpu.train.state import TrainState as JTrainState

from megaportraits_tpu_torch.core import config as tconfig
from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
from megaportraits_tpu_torch.models.gbase import Gbase
from megaportraits_tpu_torch.parallel import mesh, sharding_rules
from megaportraits_tpu_torch.train.train_base import BaseTrainer, init_states, make_train_step
from megaportraits_tpu_torch.utils.jax_bridge import _torch_key, jax_to_state_dict

from torch_port_utils import launch_ranks, numpy_fill, randomize_batch_stats

SIZE = 64
IMAGES = ("source", "driving", "source_next", "source_star", "driving_star")
LR = tconfig.Config().training.lr
SMALL_SHARDS = 4096  # TINY's trainable leaves are all below JAX's 2**16

# ---------------------------------------------------------------------------
# What the ranks run
# ---------------------------------------------------------------------------

RANK_SCRIPT = r'''
import functools, json, sys
import numpy as np
import torch
import torch.distributed as dist

from megaportraits_tpu_torch.parallel import mesh as pm
from megaportraits_tpu_torch.parallel import sharding_rules
from megaportraits_tpu_torch.train import state as train_state


def ops(work):
    """BatchNorm and cosine_loss on this rank's rows of the global inputs."""
    from megaportraits_tpu_torch.losses.cycle import cosine_loss
    from megaportraits_tpu_torch.nn.layers import BatchNorm

    dev = pm.init_distributed("cpu")
    m = pm.make_mesh({"data": 2}, device=dev)
    inp = torch.load(f"{work}/ops.pt")
    rank = dist.get_rank()
    rows = slice(2 * rank, 2 * rank + 2)
    bn = BatchNorm(inp["x"].shape[-1], device="cpu")
    bn.load_state_dict(inp["bn"])
    pm.sync_batch_norm(bn, m)
    x = inp["x"][rows].clone().requires_grad_(True)
    bn.train()
    y = bn(x, True)
    loss = (y * inp["cot"][rows]).sum()
    dx, dw, db = torch.autograd.grad(loss, [x, bn.weight, bn.bias])
    z = {k: v[rows].clone().requires_grad_(True) for k, v in inp["z"].items()}
    cos = cosine_loss([(z["pred"], z["d"]), (z["star"], z["d"])],
                      [(z["pred"], z["d_star"]), (z["star"], z["d_star"])],
                      group=pm.axis_group(m, "data"))
    dz = torch.autograd.grad(cos / 2, list(z.values()))
    # The optimiser: gradients averaged over data, then, on a model axis of
    # 2, the weight sharded (131072 elements) with the clip's norm summed
    # over the model group; 3 steps each.
    params = {}
    for name, shape in (("data", {"data": 2}), ("model", {"data": 1, "model": 2})):
        om = pm.make_mesh(shape, device=dev)
        module = torch.nn.Linear(512, 256)
        module.load_state_dict(inp["linear"])
        opt = train_state.make_optimizer(module, 0.05, 4, grad_clip=0.5, mesh=om)
        for i in range(3):
            grads = inp["grads"][i]
            if name == "data":
                grads = [g * (1 + rank) for g in grads]
            opt.step([g.clone() for g in grads])
        params[name] = (module.state_dict(), opt.state_dict()["adamw"]["state"],
                        opt.shard_dims)
    torch.save({"y": y.detach(), "dx": dx, "dw": dw, "db": db,
                "running": (bn.running_mean, bn.running_var), "cos": cos.detach(),
                "dz": dict(zip(z, dz)), "optim": params}, f"{work}/ops{rank}.pt")


def step(work, shape):
    """One stage-1 step on this rank's rows; a checkpoint of the states."""
    from megaportraits_tpu_torch.core import config as tconfig
    from megaportraits_tpu_torch.core.checkpoint import CheckpointManager
    from megaportraits_tpu_torch.core.dtypes import FP32_POLICY
    from megaportraits_tpu_torch.train.train_base import init_states, make_train_step

    train_state.fsdp_param_specs = functools.partial(
        sharding_rules.fsdp_param_specs, min_shard_size=int(sys.argv[4]))
    dev = pm.init_distributed("cpu")
    m = pm.make_mesh(json.loads(shape), device=dev)
    inp = torch.load(f"{work}/step.pt")
    cfg = tconfig.Config()
    cfg.model.arch = "tiny"
    cfg.data.train_width = cfg.data.train_height = inp["size"]
    cfg.training.steps_per_epoch = 1
    gbase, disc, ploss, g_state, d_state = init_states(
        cfg, policy=FP32_POLICY, device=dev, mesh=m, remat_mode=sys.argv[5])
    for module, key in ((gbase, "g"), (disc, "d"), (ploss, "p")):
        module.load_state_dict(inp[key])
    batch = {k: v.contiguous() for k, v in pm.shard_batch(inp["batch"], m).items()}
    g_state, d_state, metrics, _ = make_train_step(ploss, cfg, mesh=m)(g_state, d_state, batch)
    CheckpointManager(f"{work}/ckpt").save(1, {"g": g_state, "d": d_state})
    shards = {}
    for name, st in (("g", g_state), ("d", d_state)):
        for i, (master, dim) in enumerate(zip(st.tx.masters, st.tx.shard_dims)):
            if dim is not None:
                state = st.tx.adamw.state[master]
                shards[(name, i)] = (dim, {k: state[k].clone() for k in train_state.MOMENTS})
    torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                "g": gbase.state_dict(), "d": disc.state_dict(), "shards": shards,
                "model_index": pm.axis_index(m, "model")},
               f"{work}/step{dist.get_rank()}.pt")


if __name__ == "__main__":
    {"ops": lambda: ops(sys.argv[2]),
     "step": lambda: step(sys.argv[2], sys.argv[3])}[sys.argv[1]]()
    dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def rank_script(tmp_path_factory):
    path = tmp_path_factory.mktemp("ranks") / "rank_script.py"
    path.write_text(RANK_SCRIPT)
    return str(path)


class _Mesh:
    """A stand-in of a DeviceMesh of this shape, for the pure functions."""

    def __init__(self, data, model=1):
        self.mesh_dim_names = ("data", "model")
        self._sizes = (data, model)

    def size(self, dim):
        return self._sizes[dim]

    def get_local_rank(self, axis):
        return 0


# ---------------------------------------------------------------------------
# parallel/mesh.py and parallel/sharding_rules.py: the pure functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,n", [
    (None, 1), (None, 8), ({"data": 8}, 1), ({"data": 2, "model": 4}, 8),
    ({"data": 2, "model": 4}, 4), ({"data": 2, "model": 4}, 1), ({"model": 4}, 8),
    ({"model": 3}, 8), ({"data": 1, "model": 2}, 2), ({"model": 16}, 4),
    ({"data": 4, "model": 2}, 6),
])
def test_fit_mesh_shape_matches_jax(shape, n):
    assert mesh.fit_mesh_shape(shape, n) == jmesh.fit_mesh_shape(shape, n)


def test_make_mesh_without_a_group():
    """One rank and no group: None, and JAX's warning when the requested
    shape is adapted; strict raises on a mismatch."""
    assert mesh.make_mesh(device="cpu") is None
    with pytest.warns(UserWarning, match=r"adapted to \{'data': 1, 'model': 1\}"):
        assert mesh.make_mesh({"data": 2, "model": 4}, device="cpu") is None
    with pytest.raises(ValueError, match="does not match"):
        mesh.make_mesh({"data": 2}, strict=True, device="cpu")
    with pytest.raises(ValueError, match="not among"):
        mesh.make_mesh({"seq": 2}, device="cpu")


@pytest.mark.parametrize("data,batch", [(1, 1), (1, 2), (1, 7), (1, 8), (4, 4), (4, 6),
                                        (4, 32), (4, 3)])
def test_check_per_chip_batch_matches_jax(data, batch):
    """test_infra.py's cases: the same per-chip batch and the same
    divisibility warning; JAX's 2-to-7 warning (a TPU measurement) is left
    out."""
    jm = jmesh.make_mesh({"data": data}, devices=jax.devices()[:data])
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jmesh.check_per_chip_batch(batch, jm)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = mesh.check_per_chip_batch(batch, _Mesh(data))
    assert got == want
    jdiv = [w for w in jw if "does not divide" in str(w.message)]
    assert len([w for w in tw if "does not divide" in str(w.message)]) == len(jdiv)
    assert not [w for w in tw if "pathological" in str(w.message)]


def test_check_batch_divides_names_the_largest_divisor():
    """JAX's drivers shrink a data axis of 4 to 3 for a batch of 6."""
    mesh.check_batch_divides(6, _Mesh(3))
    with pytest.raises(ValueError, match=r"launch 3 processes \(a data axis of 3"):
        mesh.check_batch_divides(6, _Mesh(4))
    with pytest.raises(ValueError, match=r"launch 6 processes \(a data axis of 3"):
        mesh.check_batch_divides(6, _Mesh(4, 2))


def test_shard_batch_rows_and_unroll_axis():
    """Rank d of D takes rows [d B/D, (d+1) B/D) along the batch axis; the
    shards in rank order are the global batch. Batches stacked for
    ``unroll`` are sharded along their second axis (JAX shards the leading
    unroll axis, the fault ROADMAP pins)."""
    batch = {"x": np.arange(24).reshape(6, 4), "u": np.arange(48).reshape(2, 6, 4)}

    def on(d):
        m = _Mesh(3)
        m.get_local_rank = lambda axis: d
        return m

    shards = [mesh.shard_batch({"x": batch["x"]}, on(d)) for d in range(3)]
    np.testing.assert_array_equal(np.concatenate([s["x"] for s in shards]), batch["x"])
    unrolled = [mesh.shard_batch({"u": batch["u"]}, on(d), axis=1)["u"] for d in range(3)]
    assert unrolled[0].shape == (2, 2, 4)
    np.testing.assert_array_equal(np.concatenate(unrolled, axis=1), batch["u"])
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch({"x": np.zeros((4, 2))}, on(0))


def test_sharding_rule_matches_jax_on_test_infra_cases():
    """test_infra.py's leaves in JAX's layout, their port counterparts
    (conv HWIO -> OIHW, dense [in, out] -> [out, in]), on a model axis of 4:
    the port's dim is JAX's axis through the bridge's permutation."""
    module = torch.nn.Module()
    module.big = torch.nn.Conv2d(256, 512, 3, bias=False)     # JAX (3, 3, 256, 512)
    module.odd = torch.nn.Conv2d(7, 13, 3, bias=False)        # (3, 3, 7, 13)
    module.dense = torch.nn.Linear(2048, 512, bias=False)     # (2048, 512)
    module.bias = torch.nn.Parameter(torch.ones(512))
    jparams = {"big": np.ones((3, 3, 256, 512)), "odd": np.ones((3, 3, 7, 13)),
               "dense": np.ones((2048, 512)), "bias": np.ones((512,))}
    jspecs = jrules.fsdp_param_specs(jparams, jmesh.make_mesh({"data": 2, "model": 4}))
    got = sharding_rules.fsdp_param_specs(module, _Mesh(2, 4))
    for name, port in (("big", "big.weight"), ("odd", "odd.weight"),
                       ("dense", "dense.weight"), ("bias", "bias")):
        axis = next((i for i, a in enumerate(jspecs[name]) if a == "model"), None)
        perm = sharding_rules.jax_layout(module, port, module.get_parameter(port).ndim)
        assert got[port] == (None if axis is None else perm.index(axis)), name
    assert got["big.weight"] == 0 and got["dense.weight"] == 0
    assert got["odd.weight"] is None and got["bias"] is None
    assert all(v is None for v in sharding_rules.fsdp_param_specs(module, _Mesh(8)).values())
    kept = sharding_rules.shard_params(module, _Mesh(2, 4))
    assert kept["big.weight"].shape == (128, 256, 3, 3)
    assert kept["dense.weight"].shape == (128, 2048)
    assert kept["bias"] is module.bias and kept["odd.weight"] is module.odd.weight


@pytest.fixture(scope="module")
def full_gbase_shapes():
    """The FULL Gbase's parameter tree as ``jax.eval_shape`` gives it."""
    x = jax.numpy.zeros((1, 256, 256, 3), jax.numpy.float32)
    return jax.eval_shape(JGbase(policy=JP).init, jax.random.PRNGKey(0), x, x)["params"]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharding_rule_matches_jax_on_the_full_gbase(full_gbase_shapes, n):
    """Every leaf of the FULL Gbase: JAX's rule on JAX's tree, mapped
    through the bridge's names and permutation, equals the port's rule on
    the port's parameters; each sharded dim divides by n."""
    shapes = full_gbase_shapes
    jspecs = jrules.fsdp_param_specs(shapes, types.SimpleNamespace(
        axis_names=("data", "model"), shape={"data": 1, "model": n}))
    flat_specs = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    jax_axis = {}
    for path, spec in flat_specs:
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        jax_axis[_torch_key(keys)] = next((i for i, a in enumerate(spec) if a == "model"), -1)
    model = Gbase(policy=FP32_POLICY, device="meta")
    got = sharding_rules.fsdp_param_specs(model, _Mesh(1, n))
    assert set(got) == set(jax_axis) and len(got) > 300
    shapes_port = dict(model.named_parameters())
    sharded = 0
    for name, dim in got.items():
        p = shapes_port[name]
        perm = sharding_rules.jax_layout(model, name, p.ndim)
        want = None if jax_axis[name] < 0 else perm.index(jax_axis[name])
        assert dim == want, name
        if dim is not None:
            sharded += 1
            assert p.shape[dim] % n == 0
    assert sharded > 50


# ---------------------------------------------------------------------------
# BatchNorm and the cycle loss across ranks
# ---------------------------------------------------------------------------


def test_batch_norm_cosine_loss_and_optimiser_at_two_ranks_match_one_process(
        rank_script, tmp_path):
    from megaportraits_tpu_torch.losses.cycle import cosine_loss
    from megaportraits_tpu_torch.nn.layers import BatchNorm

    rng = np.random.default_rng(5)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    bn = BatchNorm(8, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * t(8))
        bn.bias.copy_(0.1 * t(8))
    linear = torch.nn.Linear(512, 256)
    inp = {"x": t(4, 5, 6, 8) * 2 + 1, "cot": t(4, 5, 6, 8), "bn": bn.state_dict(),
           "z": {k: t(4, 16) for k in ("pred", "star", "d", "d_star")},
           "linear": linear.state_dict(),
           "grads": [[t(256, 512) * (0.2 + i), t(256) * (0.2 + i)] for i in range(3)]}
    torch.save(inp, tmp_path / "ops.pt")
    launch_ranks([rank_script, "ops", str(tmp_path)], 2, cwd=str(tmp_path))
    got = [torch.load(tmp_path / f"ops{r}.pt") for r in range(2)]

    x = inp["x"].clone().requires_grad_(True)
    bn.train()
    y = bn(x, True)
    dx, dw, db = torch.autograd.grad((y * inp["cot"]).sum(), [x, bn.weight, bn.bias])
    tol = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([g["y"] for g in got]), y.detach(), **tol)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got]), dx, **tol)
    torch.testing.assert_close(got[0]["dw"] + got[1]["dw"], dw, **tol)
    torch.testing.assert_close(got[0]["db"] + got[1]["db"], db, **tol)
    for g in got:
        torch.testing.assert_close(g["running"][0], bn.running_mean, **tol)
        torch.testing.assert_close(g["running"][1], bn.running_var, **tol)

    z = {k: v.clone().requires_grad_(True) for k, v in inp["z"].items()}
    cos = cosine_loss([(z["pred"], z["d"]), (z["star"], z["d"])],
                      [(z["pred"], z["d_star"]), (z["star"], z["d_star"])])
    dz = dict(zip(z, torch.autograd.grad(cos, list(z.values()))))
    torch.testing.assert_close((got[0]["cos"] + got[1]["cos"]) / 2, cos.detach(), **tol)
    for k in z:
        torch.testing.assert_close(torch.cat([g["dz"][k] for g in got]), dz[k], **tol)

    # The optimiser against one process given the mean gradient ('data':
    # rank r's gradients are (1 + r) x the given ones) or the same gradient
    # ('model'); the clip acts (norms of 2 to 100 against 0.5).
    from megaportraits_tpu_torch.train.state import make_optimizer

    for name, scale in (("data", 1.5), ("model", 1.0)):
        module = torch.nn.Linear(512, 256)
        module.load_state_dict(inp["linear"])
        opt = make_optimizer(module, 0.05, 4, grad_clip=0.5)
        for grads in inp["grads"]:
            opt.step([g * scale for g in grads])
        want_state = opt.adamw.state_dict()["state"]
        for g in got:
            state, moments, shard_dims = g["optim"][name]
            assert shard_dims == ([None, None] if name == "data" else [0, None])
            for k, v in module.state_dict().items():
                torch.testing.assert_close(state[k], v, **tol)
            for i, m in want_state.items():
                for k in ("exp_avg", "exp_avg_sq"):
                    torch.testing.assert_close(moments[i][k], m[k], **tol)


# ---------------------------------------------------------------------------
# The stage-1 step at 2 ranks against JAX's single-device step
# ---------------------------------------------------------------------------


def _tiny(cfg):
    cfg.model.arch = "tiny"
    cfg.data.train_width = cfg.data.train_height = SIZE
    cfg.training.steps_per_epoch = 1
    return cfg


@pytest.fixture(scope="module")
def jax_step():
    """JAX's single-device step (its real optimiser) on numpy-drawn weights
    and a global batch of 2; the variables and what the step gave."""
    cfg = _tiny(jconfig.Config())
    gbase, disc, ploss, p_vars, g_state, d_state = jtb.init_states(
        cfg, jax.random.PRNGKey(0), policy=JP, image_size=SIZE, fast_init=True)
    g_vars = randomize_batch_stats({"params": numpy_fill(g_state.params, 1),
                                    "batch_stats": numpy_fill(g_state.batch_stats)}, seed=2)
    d_vars = {"params": numpy_fill(d_state.params, 3)}
    p_vars = numpy_fill(p_vars, 4)
    rng = np.random.default_rng(0)
    batch = {k: rng.random((2, SIZE, SIZE, 3)).astype(np.float32) for k in IMAGES}
    step = jtb.make_train_step(gbase, disc, ploss, p_vars, cfg, donate=False)
    g2, d2, metrics, _ = step(JTrainState.create(g_vars["params"], g_vars["batch_stats"],
                                                 g_state.tx),
                              JTrainState.create(d_vars["params"], None, d_state.tx), batch)
    numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return dict(
        inputs={"g": jax_to_state_dict(g_vars), "d": jax_to_state_dict(d_vars),
                "p": jax_to_state_dict(p_vars), "size": SIZE,
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
        metrics={k: float(v) for k, v in metrics.items()},
        g=jax_to_state_dict({"params": numpy(g2.params), "batch_stats": numpy(g2.batch_stats)}),
        d=jax_to_state_dict({"params": numpy(d2.params)}))


@pytest.mark.parametrize("shape,remat", [({"data": 2}, "full"),
                                         ({"data": 1, "model": 2}, "none")],
                         ids=["data2_remat_full", "model2"])
def test_two_rank_step_matches_jax_single_device(rank_script, jax_step, tmp_path, shape,
                                                 remat):
    """The data2 case recomputes every Gbase submodule in the backward pass:
    the recompute's BatchNorms reduce over the ranks again."""
    torch.save(jax_step["inputs"], tmp_path / "step.pt")
    launch_ranks([rank_script, "step", str(tmp_path), json.dumps(shape), str(SMALL_SHARDS),
                  remat], 2, cwd=str(tmp_path))
    ranks = [torch.load(tmp_path / f"step{r}.pt") for r in range(2)]
    for key in ("loss_G", "loss_D"):
        want = jax_step["metrics"][key]
        for r in ranks:
            assert abs(r["metrics"][key] - want) <= 1e-5 * abs(want), (key, r["metrics"][key])
    for net in ("g", "d"):
        # Every rank holds the same state.
        for k, v in ranks[0][net].items():
            assert torch.equal(v, ranks[1][net][k]), k
        for k, want in jax_step[net].items():
            got = ranks[0][net][k].numpy()
            if "running" in k:
                np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-4, err_msg=k)
            else:
                np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=5 * LR,
                                           err_msg=k)
    sharded = {key for key in ranks[0]["shards"]}
    assert bool(sharded) == ("model" in shape)

    # The checkpoint restores in one process: the same model and, for each
    # sharded parameter, each rank's shard of its moments, bit for bit.
    _, _, _, g_state, d_state = init_states(_tiny(tconfig.Config()), policy=FP32_POLICY,
                                            device="cpu")
    CheckpointManager(str(tmp_path / "ckpt")).restore({"g": g_state, "d": d_state})
    for net, st in (("g", g_state), ("d", d_state)):
        for k, v in st.model.state_dict().items():
            assert torch.equal(v, ranks[0][net][k]), k
        assert st.step == 1
        for r in ranks:
            for (name, i), (dim, moments) in r["shards"].items():
                if name != net:
                    continue
                whole = st.tx.adamw.state[st.tx.masters[i]]
                n = whole["exp_avg"].shape[dim] // 2
                for k, v in moments.items():
                    assert torch.equal(whole[k].narrow(dim, r["model_index"] * n, n), v)


# ---------------------------------------------------------------------------
# The drivers under torchrun
# ---------------------------------------------------------------------------


def _driver_yaml(tmp_path, clip_dir, mesh_shape, **training):
    import yaml

    cfg = {"data": {"train_width": SIZE, "train_height": SIZE},
           "model": {"arch": "tiny", "use_bf16": False},
           "training": dict(video_dir=str(clip_dir), json_file=str(clip_dir / "meta.json"),
                            checkpoint_path=str(tmp_path / "ckpt"), batch_size=2,
                            n_sample_frames=4, use_bf16=False, mesh_shape=mesh_shape,
                            log_interval=1, save_interval=2, **training)}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """npz caches of 2 clips of 6 frames at 64 and 128."""
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(3)
    for vid in ("a", "b"):
        for s in (SIZE, 2 * SIZE):
            frames = rng.random((6, s, s, 3), dtype=np.float32)
            np.savez(d / f"{vid}_{s}x{s}_tensors.npz", source_frames=frames,
                     driving_frames=frames)
    (d / "meta.json").write_text(json.dumps({"clips": {"a": {}, "b": {}}}))
    return d


def _torchrun(tmp_path, *args):
    import subprocess

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", "-m", "megaportraits_tpu_torch", *args,
                          "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-6000:]
    return out.stdout


@pytest.mark.parametrize("stage", ["base", "hr", "student"])
def test_drivers_under_torchrun(stage, clip_dir, tmp_path):
    """Each driver at 2 ranks on gloo, TINY at 64, 2 steps: rank 0 alone
    prints and writes, and the checkpoint restores in one process bit for
    bit (the driver's final state, saved twice: the step-2 save and the
    final one refused as not newer)."""
    if stage == "base":
        # unroll 2 shards the stacked batches' second axis; the held-out
        # decision is rank 0's.
        path = _driver_yaml(tmp_path, clip_dir, {"data": 2}, unroll_steps=2,
                            eval_interval=2, holdout_frames=2)
        out = _torchrun(tmp_path, "train-base", "--config", path, "--max-steps", "2")
        assert out.count("step 2/2: G=") == 1
        assert out.count("held-out self-PSNR") == 1
        key, export_key = "g", "g_variables"
    elif stage == "hr":
        path = _driver_yaml(tmp_path, clip_dir, {"data": 1, "model": 2})
        out = _torchrun(tmp_path, "train-hr", "--config", path, "--max-steps", "2")
        assert out.count("hr step 2/2") == 1
        key, export_key = "genh", "genh_variables"
    else:
        path = _driver_yaml(tmp_path, clip_dir, {"data": 2}, num_avatars=2)
        out = _torchrun(tmp_path, "train-student", "--config", path, "--max-steps", "2")
        assert out.count("student step 2/2") == 1
        key, export_key = "student", None
    ckpt = tmp_path / "ckpt"
    assert sorted(os.listdir(ckpt)) == (["2", "export"] if export_key else ["2"])
    saved = torch.load(ckpt / "2" / "checkpoint.pt")[key]
    assert saved["step"] == 2
    cfg = _tiny(tconfig.load_config(path))
    if stage == "base":
        _, _, _, state, _ = init_states(cfg, policy=FP32_POLICY, device="cpu")
    elif stage == "hr":
        from megaportraits_tpu_torch.train.train_hr import init_hr_state

        _, _, state = init_hr_state(cfg, policy=FP32_POLICY, image_size=SIZE, device="cpu")
    else:
        from megaportraits_tpu_torch.train.train_student import init_student_state

        _, state = init_student_state(cfg, policy=FP32_POLICY, image_size=SIZE,
                                      device="cpu")
    CheckpointManager(str(ckpt)).restore({key: state})
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    restored = state.tx.state_dict()["adamw"]["state"]
    for i, moments in saved["adamw"]["state"].items():
        for k, v in moments.items():
            assert torch.equal(restored[i][k], v), (i, k)
    if export_key:
        export = torch.load(ckpt / "export" / "2" / "checkpoint.pt")[export_key]
        assert export.keys() == saved["model"].keys()


# ---------------------------------------------------------------------------
# Gbase remat
# ---------------------------------------------------------------------------


def test_init_states_picks_jax_remat_default():
    cfg = _tiny(tconfig.Config())
    for size, want in ((64, "none"), (255, "none"), (256, "selective"), (512, "selective")):
        gbase, *_ = init_states(cfg, policy=FP32_POLICY, device="cpu", image_size=size)
        assert gbase.remat == want, size
    gbase, *_ = init_states(cfg, policy=FP32_POLICY, device="cpu", remat_mode="full")
    assert gbase.remat == "full"
    with pytest.raises(ValueError, match="remat must be one of"):
        Gbase(remat="everything", device="meta")


def test_remat_gives_the_step_of_no_remat():
    """A TINY step from the same weights and batch under each mode: the
    metrics, the prediction, every parameter after the step and G's
    BatchNorm statistics equal bit for bit (a BatchNorm that recorded its
    statistics again in the recompute would move them twice)."""
    cfg = _tiny(tconfig.Config())
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.random((2, SIZE, SIZE, 3)).astype(np.float32))
             for k in IMAGES}
    results = {}
    for mode in ("none", "selective", "full"):
        gbase, disc, ploss, g_state, d_state = init_states(
            cfg, policy=FP32_POLICY, device="cpu", remat_mode=mode)
        stats_before = {k: v.clone() for k, v in gbase.named_buffers()}
        _, _, metrics, xhat = make_train_step(ploss, cfg)(g_state, d_state, batch)
        results[mode] = (metrics, xhat, gbase.state_dict(), disc.state_dict())
    metrics, xhat, g, d = results["none"]
    assert any(not torch.equal(v, stats_before[k]) for k, v in gbase.named_buffers())
    for mode in ("selective", "full"):
        m2, x2, g2, d2 = results[mode]
        assert {k: v.item() for k, v in m2.items()} == {k: v.item() for k, v in metrics.items()}
        assert torch.equal(x2, xhat), mode
        for want, got in ((g, g2), (d, d2)):
            for k, v in want.items():
                assert torch.equal(got[k], v), (mode, k)


def test_base_trainer_bundles_the_stage():
    cfg = _tiny(tconfig.Config())
    gbase, disc, ploss, _, _ = init_states(cfg, policy=FP32_POLICY, device="cpu")
    trainer = BaseTrainer(gbase, disc, ploss, make_train_step(ploss, cfg))
    assert trainer._fields == ("gbase", "disc", "ploss", "train_step")
    assert trainer.gbase is gbase and callable(trainer.train_step)
