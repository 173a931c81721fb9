"""The rank side of the port's two-process tests (`test_torch_parallel.py`,
`test_torch_dp_train.py`).

    python tests/torch_dp_worker.py <cases.pt> <rank>

`cases.pt` (written by the test with `torch.save`) holds `ports` (free
localhost ports: the first for the cases' process group, the rest for the
CLI runs, which join their own) and `cases`, {name: inputs}. This rank
joins a gloo group of `world` processes on 127.0.0.1, runs every case in
the order given, and writes {name: result} to `<dir>/rank<r>.pt`. It
imports the port only: no JAX, no test module.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cvpr23_lfdm_torch.parallel import distributed as D  # noqa: E402
from cvpr23_lfdm_torch.parallel import mesh as M  # noqa: E402

GROUP_TIMEOUT_S = 120


def _named_grads(module) -> dict:
    return {k: p.grad.clone() for k, p in module.named_parameters() if p.grad is not None}


def _state(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


# ------------------------------------------------------------------ cases


def case_basics(inp, rank):
    mesh = M.make_mesh(device="cpu")
    out = {"primary": D.is_primary(), "index": D.process_index(), "count": D.process_count(),
           "host_shard": D.host_shard(8), "mesh": (mesh.size, mesh.rank, mesh.shape),
           "device": str(mesh.device)}
    try:
        D.host_shard(7)
    except ValueError as e:
        out["host_shard_7"] = str(e)
    batch = {"x": inp["x"], "names": ["a", "b"], "local": inp["x"][:2]}
    out["shard_batch"] = M.shard_batch(batch, mesh, 4)
    out["local_rows_dim1"] = M.local_rows(inp["x"].reshape(2, 4, -1), mesh, dim=1)
    out["gathered"] = M.all_gather_rows(M.local_rows(inp["x"], mesh), mesh)
    out["one_rank_mesh"] = M.make_mesh(1, device="cpu").size
    return out


def case_mean_grad(inp, rank):
    """A least-squares step on this rank's rows, gradients averaged."""
    mesh = M.make_mesh(device="cpu")
    w = torch.nn.Parameter(inp["w"].clone())
    x, y = M.local_rows(inp["x"], mesh), M.local_rows(inp["y"], mesh)
    loss = ((x @ w - y) ** 2).mean()
    loss.backward()
    M.mean_gradients([w], mesh)
    with torch.no_grad():
        w -= inp["lr"] * w.grad
    return {"grad": w.grad.clone(), "w": w.detach().clone(),
            "loss": M.mean_metrics({"loss": loss.detach()}, mesh, ["loss"])["loss"]}


def case_replicate(inp, rank):
    mesh = M.make_mesh(device="cpu")
    torch.manual_seed(rank + 1)
    net = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    opt = torch.optim.Adam(net.parameters())
    net(torch.randn(5, 4)).sum().backward()
    opt.step()
    before = M.states_agree(net, mesh), M.states_agree(opt, mesh)
    M.replicate(net, mesh)
    M.replicate(opt, mesh)
    return {"before": before, "after": (M.states_agree(net, mesh), M.states_agree(opt, mesh)),
            "state": _state(net), "moments": [s["exp_avg"].clone() for s in opt.state.values()]}


def case_syncbn(inp, rank):
    """Two train-mode updates of `BatchNorm` over the group; the loss of a
    rank is sum(y * cot) over its rows, the global loss their sum."""
    from cvpr23_lfdm_torch.models.blocks import BatchNorm, sync_batchnorm

    mesh = M.make_mesh(device="cpu")
    bn = BatchNorm(inp["scale"].shape[0])
    bn.load_state_dict({"weight": inp["scale"], "bias": inp["bias"],
                        "running_mean": torch.zeros_like(inp["scale"]),
                        "running_var": torch.ones_like(inp["scale"])})
    sync_batchnorm(bn, mesh.group).train()
    out = []
    for x in inp["xs"]:
        bn.zero_grad()
        tx = M.local_rows(x, mesh).clone().requires_grad_()
        y = bn(tx)
        (y * M.local_rows(inp["cot"], mesh)).sum().backward()
        grads = torch.stack([bn.weight.grad, bn.bias.grad])
        dist.all_reduce(grads)  # the global loss is the sum of the ranks'
        out.append({"y": y.detach(), "dx": tx.grad, "dweight": grads[0], "dbias": grads[1],
                    "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()})
    return out


def case_serving(inp, rank):
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
    from cvpr23_lfdm_torch.parallel.serving import sample_video_sharded

    cfg = inp["cfg"]
    mesh = M.make_mesh(device="cpu")
    model = FlowDiffusion(cfg.lfae, cfg.diffusion, device="cpu")
    model.load_state_dict(inp["model"])
    injected = sample_video_sharded(model, mesh, inp["ref"], inp["cond"], 1.0,
                                    init_img=inp["init"], noise_seq=inp["noise"])
    gen = torch.Generator().manual_seed(inp["seed"])
    drawn = sample_video_sharded(model, mesh, inp["ref"], inp["cond"], 1.0, generator=gen)
    return {"injected": injected, "drawn": drawn}


def case_dm_steps(inp, rank):
    """DMTrainer steps on this rank's rows of global batches; the draws are
    the global ones given (`draws`), or from `step_generator(seed, i)`."""
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
    from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer, step_generator

    cfg = inp["cfg"]
    mesh = M.make_mesh(device="cpu")
    model = FlowDiffusion(cfg.lfae, cfg.diffusion, device="cpu", training=True)
    model.load_state_dict(inp["model"])
    trainer = DMTrainer(cfg, inp["steps_per_epoch"], model=model, mesh=mesh)
    state = trainer.init_state()
    out = []
    for i, batch in enumerate(inp["batches"]):
        local = M.shard_batch(batch, mesh, batch["cond"].shape[0])
        if inp.get("draws"):
            t, noise, null = inp["draws"][i]
            state, m = trainer.train_step(state, None, local, t=t, noise=noise, null_mask=null)
        else:
            state, m = trainer.train_step(state, step_generator(inp["seed"], i, "cpu"), local)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "grads": _named_grads(trainer.model.unet), "unet": _state(trainer.model.unet),
                    "agree": M.states_agree(trainer.model.unet, mesh)})
    return out


def case_lfae_steps(inp, rank):
    """LFAETrainer steps (synchronised BatchNorm) on this rank's rows; the
    global TPS transforms given, or drawn from `step_generator(seed, i)`."""
    from cvpr23_lfdm_torch.train.dm_trainer import step_generator
    from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer
    from cvpr23_lfdm_torch.train.losses import TPSTransform

    cfg = inp["cfg"]
    mesh = M.make_mesh(device="cpu")
    trainer = LFAETrainer(cfg, 10, device="cpu", mesh=mesh)
    trainer.model.load_state_dict(inp["model"])
    trainer.vgg.load_state_dict(inp["vgg"])
    state = trainer.init_state()
    out = []
    for i, batch in enumerate(inp["batches"]):
        local = M.shard_batch(batch, mesh, batch["source"].shape[0])
        if inp.get("transforms"):
            theta, cpar = inp["transforms"][i]
            tps = TPSTransform.from_params(theta, cpar, cfg.lfae_train.points_tps)
            state, m = trainer.train_step(state, None, local, transform=tps)
        else:
            state, m = trainer.train_step(state, step_generator(inp["seed"], i, "cpu"), local)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "grads": _named_grads(trainer.model), "model": _state(trainer.model),
                    "agree": M.states_agree(trainer.model, mesh)})
    return out


def case_cli(inp, rank, ports):
    """The CLIs as two processes (each run joins its own group): `train_dm`
    (`train` argv), then `--resume` (`resume` argv), then `demo --mesh
    dp=2`, each through its `setup` and `process_group` as `main` does, at
    the given tiny config. Records which rank wrote checkpoint files."""
    from cvpr23_lfdm_torch.scripts import _common, demo, train_dm
    from cvpr23_lfdm_torch.utils.checkpoint import CheckpointManager

    written = []
    real_write = CheckpointManager._write_state

    def recording(self, name, state):
        written.append(name)
        return real_write(self, name, state)

    CheckpointManager._write_state = recording

    def run(module, argv, port, cfg):
        args = module.parser().parse_args([*argv, "--coordinator", f"127.0.0.1:{port}",
                                           "--num-processes", "2", "--process-id", str(rank)])
        _common.setup(args, multi_device=True)
        with _common.process_group(args):
            return module.run(cfg, args)

    out = {}
    for name, port in (("train", ports[0]), ("resume", ports[1])):
        before = len(written)
        res = run(train_dm, inp[name], port, inp["cfg"])
        out[name] = {"start": res["start_step"], "step": res["state"].step, "written": written[before:],
                     "unet": _state(res["trainer"].model.unet)}
    demo.BENCH_CKPT = os.path.join(inp["demo_dir"], "none")  # seeded weights
    argv = [*inp["demo"], "--log-dir", os.path.join(inp["demo_dir"], f"rank{rank}")]
    res = run(demo, argv, ports[2], inp["demo_cfg"])
    out["demo"] = {"gifs": res["gifs"], "outputs": res["outputs"]}
    return out


CASES = {"basics": case_basics, "mean_grad": case_mean_grad, "replicate": case_replicate,
         "syncbn": case_syncbn, "serving": case_serving, "dm_steps": case_dm_steps,
         "lfae_steps": case_lfae_steps}


def main(path: str, rank: int) -> None:
    torch.set_num_threads(1)
    spec = torch.load(path, weights_only=False)  # written by the test that spawned this process
    ports, cases = spec["ports"], dict(spec["cases"])
    cli = cases.pop("cli", None)
    results = {}
    D.init_distributed(f"127.0.0.1:{ports[0]}", 2, rank, device="cpu", timeout_s=GROUP_TIMEOUT_S)
    try:
        for name, inp in cases.items():
            results[name] = CASES[inp.get("case", name)](inp, rank)
    finally:
        D.shutdown_distributed()
    if cli is not None:
        results["cli"] = case_cli(cli, rank, ports[1:])
    torch.save(results, os.path.join(os.path.dirname(path), f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
