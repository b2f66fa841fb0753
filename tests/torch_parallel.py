"""Ranks for the port's parallel-layer tests (``tests/test_torch_*_parallel.py``).

:func:`run_ranks` starts ``world`` processes (``spawn``), joins them into
one gloo process group through a ``file://`` rendezvous in the test's
directory, runs a worker of this module on every rank and returns each
rank's result. A worker gets ``(rank, world, workdir, *args)``; its inputs
come from the test process (numpy arrays, state dicts) and its outputs go
back through ``torch.save``. This module imports no JAX, so the ranks are
plain torch processes; the tests hold their results against the JAX
package in the test process.
"""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent


def _entry(fn, rank, world, workdir, args):
    torch.set_num_threads(1)
    from vit4hep_tpu_torch.parallel import mesh

    try:
        mesh.init_distributed("gloo", "cpu", init_method=f"file://{workdir}/rendezvous",
                              rank=rank, world_size=world, timeout_s=120)
        torch.save(fn(rank, world, Path(workdir), *args), Path(workdir) / f"out{rank}.pt")
    except BaseException:
        (Path(workdir) / f"err{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, workdir, *args, timeout=240):
    """``fn(rank, world, workdir, *args)`` on ``world`` gloo ranks; the list
    of their results. A rank that fails or outlives ``timeout`` seconds
    fails the call (every rank is then killed)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(workdir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = {r: (workdir / f"err{r}.txt").read_text() for r in range(world)
              if (workdir / f"err{r}.txt").exists()}
    codes = [p.exitcode for p in procs]
    if hung or errors or any(codes):
        raise AssertionError(f"ranks hung past {timeout} s: {hung}; exit codes {codes}; "
                             + "\n".join(f"rank {r}:\n{e}" for r, e in errors.items()))
    return [torch.load(workdir / f"out{r}.pt", weights_only=False) for r in range(world)]


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# models shared with the test files
# ---------------------------------------------------------------------------
def tiny_cfm(param, shape, patch_shape, odeint_kwargs=None):
    """A port CaloChallengeCFM over a ViT of ``param``."""
    from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCFM
    from vit4hep_tpu_torch.models.vit import ViT

    return CaloChallengeCFM(ViT(param), patch_shape=patch_shape, shape=shape,
                            odeint_kwargs=odeint_kwargs)


def training_cfg(**kw):
    from vit4hep_tpu_torch.utils.config import Config

    cfg = dict(lr=1e-3, iterations=10, optimizer="AdamW", betas=[0.9, 0.999], eps=1e-6,
               weight_decay=0.1, scheduler="CosineAnnealingLR", scheduler_scale=1,
               cosanneal_eta_min=0)
    cfg.update(kw)
    return Config(cfg)


def state_of(model, sd, training, use_ema=True):
    """A fresh train state of ``model`` with the net's state dict ``sd``."""
    from vit4hep_tpu_torch.experiments import train_state as ts

    model.net.load_state_dict(sd)
    return ts.create_train_state(model, training, use_ema)


def explicit_step(model, mesh=None, ema=True):
    """A train step whose batch is (x, c, t, x_0): the draws given."""
    from vit4hep_tpu_torch.experiments import train_state as ts

    return ts.make_train_step(lambda x, c, t, x0: model.batch_loss(x, c, t=t, x_0=x0),
                              clip_grad_norm=1.0, ema_decay=0.999 if ema else None, mesh=mesh)


L, A, R = 6, 4, 3  # the tiny ds2-like geometry of the experiment runs


def tiny_ds2(work: Path, base: Path, batch, *extra):
    """Overrides of calochallenge_ds2 at a tiny geometry (those of
    ``tests/test_torch_experiment.py``; its binning file and showers in
    ``work``), 4 steps validating every 2, saving under ``base``."""
    v = L * A * R
    return [f"data_dir={work}", f"base_dir={base}", "exp_name=Tiny", "run_name=run", "seed=3",
            f"model.shape=[{L},{A},{R}]", "model.patch_shape=[3,4,1]",
            "model.net.param.num_patches=[[2,1,3]]", "model.net.param.patch_dim=12",
            f"model.net.param.condition_dim={L + 1}", "model.net.param.hidden_dim=48",
            "model.net.param.depth=2", "model.net.param.num_heads=4",
            "model.net.param.attn_impl=fused",
            f"data.transforms.ScaleTotalEnergy.n_layers={L}",
            f"data.transforms.CutValues.n_layers={L}",
            f"data.transforms.AddFeaturesToCond.split_index={v}",
            f"data.transforms.Reshape.shape=[1,{L},{A},{R}]",
            "data.train_val_frac=[0.8,0.2]", f"training.batchsize={batch}", "evaluate=false",
            "plot=false", "plotting.loss=false", "save_source=false", "ema=true", "save=true",
            "training.iterations=4", "training.validate_every_n_steps=2", *extra]


def experiment_run(rank, world, overrides):
    """The tiny ds2 experiment on this rank: what the tests read of it."""
    from vit4hep_tpu_torch.experiments.calochallenge import CaloChallenge
    from vit4hep_tpu_torch.utils.config import compose

    cfg = compose(str(ROOT / "configs"), "calochallenge/cfm/calochallenge_ds2", overrides)
    exp = CaloChallenge(cfg, rank=rank, world_size=world, device="cpu")
    exp()
    return {"batch_size": exp.batch_size, "train_loss": exp.train_loss,
            "val_loss": exp.val_loss, "save": exp.cfg.save, "run_dir": exp.cfg.run_dir,
            "grid": exp.mesh.shape,
            "qkv_after": tuple(exp.model.net.blocks[0].attn.qkv.weight.shape)}


def whole_state(state):
    """A train state's whole state dict, on the CPU."""
    from vit4hep_tpu_torch.parallel.sharding_rules import gather_state_dict

    return gather_state_dict(state)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------
def tp_worker(rank, world, workdir, case):
    """On a (world / 2, 2) grid: the 144-token ViT's forward (and a
    3-head one's), a train step on the global batch, its checkpoint both
    ways, and a sample through the K2v twin."""
    from vit4hep_tpu_torch.parallel import mesh as mesh_lib
    from vit4hep_tpu_torch.parallel.sharding_rules import (Shard, sharded_params,
                                                           shard_tree)
    from vit4hep_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    mesh = mesh_lib.create_mesh(model_parallel=2)
    out = {"grid": mesh.shape}
    x, t, c = (_t(case[k]) for k in ("x", "t", "c"))

    model = tiny_cfm(case["param"], case["shape"], case["patch_shape"])
    model.net.load_state_dict(case["sd"])
    shard_tree(model, mesh)
    qkv = model.net.blocks[0].attn.qkv
    out["qkv_local"] = tuple(qkv.weight.shape)
    with torch.no_grad():
        out["fwd"] = model(x, t, c)

    m3 = tiny_cfm(case["param3"], case["shape"], case["patch_shape"])
    m3.net.load_state_dict(case["sd3"])
    shard_tree(m3, mesh)
    blk = m3.net.blocks[0]
    out["heads3_split"] = sorted(sharded_params(m3.net))
    out["heads3_attn_group"] = blk.attn.tp_group is not None
    with torch.no_grad():
        out["fwd3"] = m3(x, t, c)

    training = training_cfg()
    state = state_of(tiny_cfm(case["param"], case["shape"], case["patch_shape"]), case["sd"],
                     training)
    state = mesh_lib.shard_state(state, mesh)
    step = explicit_step(state.model, mesh)
    batch = mesh_lib.shard_batch(tuple(_t(case[k]) for k in ("xb", "cb", "tb", "x0b")), mesh)
    out["metrics"] = {k: float(v) for k, v in step(state, batch).items()}
    out["after"] = whole_state(state)
    out["still_split"] = tuple(state.model.net.blocks[0].attn.qkv.weight.shape)
    save_checkpoint(workdir / "tp.pt", state, write=rank == 0)
    mesh_lib.barrier()

    back = state_of(tiny_cfm(case["param"], case["shape"], case["patch_shape"]), case["sd"],
                    training)
    back = mesh_lib.shard_state(back, mesh)
    load_checkpoint(case["full"], back)
    whole = torch.load(case["full"], weights_only=True)
    ok = []
    for name, p in sharded_params(back.model).items():
        shard: Shard = p.tp_shard
        ok.append(torch.equal(p.detach(), shard.split(whole["model"][name])))
    out["loaded_parts_exact"] = bool(ok) and all(ok)
    out["loaded_step"] = back.step

    sampler = tiny_cfm(case["param_sample"], case["shape"], case["patch_shape"],
                       case["odeint"])
    sampler.net.load_state_dict(case["sd"])
    shard_tree(sampler, mesh)
    out["sample"] = sampler.sample_batch(c, x_T=_t(case["x_T"]))
    out["exp"] = experiment_run(rank, world, case["experiment"])
    return out


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------
def dp_worker(rank, world, workdir, case):
    """On a (2, 1) grid: two train steps with the draws given, two with
    the draws made from a generator, and the tiny ds2 experiment."""
    from vit4hep_tpu_torch.experiments import train_state as ts
    from vit4hep_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.create_mesh()
    out = {"grid": mesh.shape, "rows": mesh.rows(8)}
    training = training_cfg()
    model = tiny_cfm(case["param"], case["shape"], case["patch_shape"])
    state = mesh_lib.shard_state(state_of(model, case["sd"], training), mesh)
    step = explicit_step(model, mesh)
    out["explicit"] = []
    for batch in case["batches"]:
        metrics = step(state, mesh_lib.shard_batch(tuple(map(_t, batch)), mesh))
        out["explicit"].append(({k: float(v) for k, v in metrics.items()},
                                {k: v.clone() for k, v in model.net.state_dict().items()}))

    model = tiny_cfm(case["param"], case["shape"], case["patch_shape"])
    state = mesh_lib.shard_state(state_of(model, case["sd"], training), mesh)
    gen = torch.Generator().manual_seed(11)
    step = ts.make_train_step(
        lambda x, c: model.batch_loss(x, c, generator=gen, rows=mesh.rows(len(x) * mesh.data)),
        clip_grad_norm=1.0, ema_decay=0.999, mesh=mesh)
    out["drawn"] = []
    for batch in case["batches"]:
        metrics = step(state, mesh_lib.shard_batch(tuple(map(_t, batch[:2])), mesh))
        out["drawn"].append(float(metrics["loss"]))
    out["drawn_params"] = {k: v.clone() for k, v in model.net.state_dict().items()}

    out["exp"] = experiment_run(rank, world, case["experiment"])
    return out


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------
def ring_worker(rank, world, workdir, case):
    """Ring attention over ranks (0, 1) and over all four ranks: the
    forward, the gradients of sum(out^2), the packed qkv layout, and an N
    the ring does not divide."""
    from vit4hep_tpu_torch.parallel.sequence_parallel import ring_attention

    groups = {2: dist.new_group([0, 1]), 4: dist.group.WORLD}
    out = {}
    for n, group in groups.items():
        if rank >= n:
            continue
        q, k, v = (_t(a) for a in case["exact"])
        with torch.no_grad():
            out[("exact", n)] = ring_attention(q, k, v, group)
        q, k, v = (_t(a).requires_grad_() for a in case["grad"])
        (ring_attention(q, k, v, group) ** 2).sum().backward()
        out[("grad", n)] = (q.grad, k.grad, v.grad)
        b, nt, three_hd = case["qkv"].shape
        h, d = 2, three_hd // 6
        q5 = _t(case["qkv"]).reshape(b, nt, 3, h, d)
        q, k, v = (q5[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        with torch.no_grad():
            out[("packed", n)] = ring_attention(q, k, v, group).permute(0, 2, 1, 3).reshape(
                b, nt, h * d)
        try:
            ring_attention(q[:, :, :-1], k[:, :, :-1], v[:, :, :-1], group)
            out[("indivisible", n)] = "no error"
        except ValueError as e:
            out[("indivisible", n)] = str(e)
    return out


# ---------------------------------------------------------------------------
# the GPipe pipeline
# ---------------------------------------------------------------------------
def mlp_block(p, x, c):
    return x + torch.tanh((x + c[:, None, :]) @ p["w1"]) @ p["w2"]


def pipe_worker(rank, world, workdir, case):
    """The pipeline over 2 and 4 stages: outputs against microbatch counts,
    the gradients of sum(out^2) summed over the stages, and DiT blocks."""
    from vit4hep_tpu_torch.models.vit import DiTBlock
    from vit4hep_tpu_torch.parallel.pipeline import pipelined_stack, spmd_pipeline

    groups = {2: dist.new_group([0, 1]), 4: dist.group.WORLD}
    params = [{k: _t(v) for k, v in p.items()} for p in case["params"]]
    x, c = _t(case["x"]), _t(case["c"])
    out = {}
    for n_stages, n_micro in case["schedules"]:
        if rank < n_stages:
            with torch.no_grad():
                out[(n_stages, n_micro)] = pipelined_stack(mlp_block, params, groups[n_stages],
                                                           x, c, n_micro=n_micro)

    gp = [{k: _t(v).requires_grad_() for k, v in p.items()} for p in case["grad_params"]]
    loss = (pipelined_stack(mlp_block, gp, groups[4], _t(case["gx"]), _t(case["gc"])) ** 2).sum()
    loss.backward()
    grads = [{k: v.grad.clone() for k, v in p.items()} for p in gp]
    for g in grads:  # each rank holds its stage's blocks' gradients
        for v in g.values():
            dist.all_reduce(v)
    out["grads"] = grads

    block = DiTBlock(case["hid"], num_heads=2, mlp_ratio=2.0, attn_impl="xla")
    per_block = [{k: _t(v) for k, v in sd.items()} for sd in case["dit"]]

    def dit_fn(p, xx, cc):
        return torch.func.functional_call(block, p, (xx, cc))

    from vit4hep_tpu_torch.parallel.pipeline import stack_stage_params

    mine = {k: v[rank] for k, v in stack_stage_params(per_block, 4).items()}
    n_micro = 4
    xd, cd = _t(case["dx"]), _t(case["dc"])
    with torch.no_grad():
        out["dit"] = spmd_pipeline(
            dit_fn, mine, xd.reshape(n_micro, -1, *xd.shape[1:]),
            cd.reshape(n_micro, -1, *cd.shape[1:]), group=groups[4]).reshape(xd.shape)
    return out


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def launch_env(rank, world, port):
    """The torchrun variables of one rank of a local run."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
               OMP_NUM_THREADS="1")
    return env
