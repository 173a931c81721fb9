"""The rank side of the port's multi-process tests (`test_torch_parallel.py`,
`test_torch_dp_train.py`, `test_torch_tp.py`, `test_torch_tp_mesh.py`,
`test_torch_sp.py`).

    python tests/torch_dp_worker.py <cases.pt> <rank>

`cases.pt` (written by the test with `torch.save`) holds `ports` (free
localhost ports: the first for the cases' process group, the rest for the
CLI runs, which join their own), `world` (the number of processes, 2 if
absent) and `cases`, {name: inputs}. This rank joins a gloo group of
`world` processes on 127.0.0.1, runs every case in the order given, and
writes {name: result} to `<dir>/rank<r>.pt`. It imports the port only: no
JAX, no test module.
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


def _run_cli(module, argv, port, cfg, rank, world):
    """A CLI in this process through its `setup` and `process_group`, as
    `main` does, joined to its own group of `world` processes."""
    from cvpr23_lfdm_torch.scripts import _common

    args = module.parser().parse_args([*argv, "--coordinator", f"127.0.0.1:{port}",
                                       "--num-processes", str(world), "--process-id", str(rank)])
    _common.setup(args, multi_device=True, serving=module.__name__.endswith(("demo", "test_dm")))
    with _common.process_group(args):
        return module.run(cfg, args)


def case_tp_cli(inp, rank, ports, world):
    """`demo` (with `inp["demo"]`) or `test_dm` (with `inp["test_dm"]`) on a
    mesh with a `model` or `space` axis; the demo's outputs and GIFs,
    `test_dm`'s result."""
    from cvpr23_lfdm_torch.scripts import demo, test_dm

    out = {}
    if "demo" in inp:
        demo.BENCH_CKPT = os.path.join(inp["dir"], "none")  # seeded weights
        argv = [*inp["demo"], "--log-dir", os.path.join(inp["dir"], f"rank{rank}")]
        res = _run_cli(demo, argv, ports[0], inp["cfg"], rank, world)
        out["demo"] = {"gifs": res["gifs"], "outputs": res["outputs"]}
    if "test_dm" in inp:
        argv = [*inp["test_dm"], "--log-dir", os.path.join(inp["dir"], f"rank{rank}")]
        out["test_dm"] = _run_cli(test_dm, argv, ports[1], inp["cfg"], rank, world)
    return out


def case_cli(inp, rank, ports):
    """The CLIs as two processes (each run joins its own group): `train_dm`
    (`train` argv), then `--resume` (`resume` argv), then `demo --mesh
    dp=2`, each through its `setup` and `process_group` as `main` does, at
    the given tiny config. Records which rank wrote checkpoint files."""
    from cvpr23_lfdm_torch.scripts import demo, train_dm
    from cvpr23_lfdm_torch.utils.checkpoint import CheckpointManager

    written = []
    real_write = CheckpointManager._write_state

    def recording(self, name, state):
        written.append(name)
        return real_write(self, name, state)

    CheckpointManager._write_state = recording

    def run(module, argv, port, cfg):
        return _run_cli(module, argv, port, cfg, rank, 2)

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


def _tp_mesh(inp):
    return M.make_mesh(tuple(inp["mesh"]), ("data", "model"), device="cpu")


def case_tp_meshes(inp, rank):
    """(data index, model index, axis sizes) of this rank on a 2 x 2 mesh
    in both axis orders; a model-group sum and a data-group sum of the
    rank number."""
    out = {}
    for names in (("data", "model"), ("model", "data")):
        mesh = M.make_mesh((2, 2), names, device="cpu")
        x = torch.tensor([float(rank)])
        out[names] = (mesh.rank, mesh.model_rank, mesh.shape, float(M.reduce_from_model(x, mesh)),
                      float(M.all_reduce_sum(x, mesh.group)))
    return out


def case_tp_forms(inp, rank):
    """A UNet forward in each form (and `pallas3` with the fused norm) on a
    `model` axis of 2, from the same one-process weights; for `xla` the
    gathered gradients of a weighted sum of the output as well."""
    from cvpr23_lfdm_torch.models.unet3d import Unet3D, shard_unet, tp_parameters

    mesh = _tp_mesh(inp)
    out = {}
    for impl, fused_norm in inp["forms"]:
        net = Unet3D(**inp["kwargs"], temporal_attn_impl=impl, fused_norm=fused_norm)
        net.load_state_dict(inp["state"])
        shard_unet(net, mesh)
        train = impl == "xla"
        with torch.set_grad_enabled(train):
            y = net(*inp["args"], fea=inp["fea"])
        res = {"out": y.detach()}
        if train:
            (y * inp["cot"]).sum().backward()
            M.sum_model_gradients(tp_parameters(net)[1], mesh)
            res["grads"] = M.gather_variables(_named_grads(net), mesh, net.tp_shapes)
        out[f"{impl}{'+norm' if fused_norm else ''}"] = res
    return out


def case_tp_serving(inp, rank):
    """`sample_video_sharded` on a `data` x `model` mesh, the UNet sharded by
    it; this rank's shards of the entries named in `inspect`, and whether
    `gather_variables` gives back the one-process UNet bit for bit."""
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
    from cvpr23_lfdm_torch.parallel.serving import sample_video_sharded

    cfg = inp["cfg"]
    mesh = _tp_mesh(inp)
    model = FlowDiffusion(cfg.lfae, cfg.diffusion, device="cpu")
    model.load_state_dict(inp["model"])
    full = _state(model.unet)
    out = sample_video_sharded(model, mesh, inp["ref"], inp["cond"], 1.0,
                               init_img=inp["init"], noise_seq=inp["noise"])
    local = _state(model.unet)
    gathered = M.gather_variables(local, mesh, model.unet.tp_shapes)
    return {"out": out, "mesh": (mesh.size, mesh.rank, mesh.model_size, mesh.model_rank, mesh.shape),
            "gather_exact": set(gathered) == set(full) and all(torch.equal(gathered[k], full[k]) for k in full),
            "shards": {k: local[k] for k in inp["inspect"]},
            "heads": [m.heads for m in model.unet.modules() if hasattr(m, "heads")]}


def case_tp_dm_step(inp, rank):
    """One `DMTrainer` step on a `data` x `model` mesh from the global
    batch's injected draws: metrics, the gathered gradients and state,
    `states_agree` over both axes, then the state through a checkpoint
    (rank 0 writes the one-process format) into a new tp trainer."""
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
    from cvpr23_lfdm_torch.models.unet3d import tp_parameters
    from cvpr23_lfdm_torch.train.dm_trainer import DMTrainer
    from cvpr23_lfdm_torch.utils.checkpoint import CheckpointManager

    cfg = inp["cfg"]
    mesh = _tp_mesh(inp)

    def trainer():
        model = FlowDiffusion(cfg.lfae, cfg.diffusion, device="cpu", training=True)
        model.load_state_dict(inp["model"])
        return DMTrainer(cfg, inp["steps_per_epoch"], model=model, mesh=mesh)

    tr = trainer()
    state = tr.init_state()
    batch = inp["batch"]
    local = M.shard_batch(batch, mesh, batch["cond"].shape[0])
    t, noise, null = inp["draws"]
    state, m = tr.train_step(state, None, local, t=t, noise=noise, null_mask=null)
    unet = tr.model.unet
    _, partial, whole = tp_parameters(unet)
    saved = tr.state_dict(state)
    ckpt = CheckpointManager(inp["ckpt_dir"])
    ckpt.save(saved, step=state.step)
    back = trainer()
    restored_step = back.load_state_dict(ckpt.restore("latest", map_location="cpu")).step
    again = back.state_dict(state)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": M.gather_variables(_named_grads(unet), mesh, unet.tp_shapes),
            "unet": saved["unet"], "moments": {k: s["exp_avg"] for k, s in saved["optimizer"]["state"].items()},
            "agree_data": M.states_agree(unet, mesh) and M.states_agree(tr.optimizer, mesh),
            "agree_model": M.states_agree(partial + whole, mesh, axis="model"),
            "param_bytes": sum(p.numel() * p.element_size() for p in unet.parameters()),
            "restored": restored_step == state.step
            and all(torch.equal(again["unet"][k], saved["unet"][k]) for k in saved["unet"])
            and all(torch.equal(again["optimizer"]["state"][i][key], s[key])
                    for i, s in saved["optimizer"]["state"].items() for key in ("exp_avg", "exp_avg_sq"))}


def case_sp_meshes(inp, rank):
    """On each mesh of `inp["meshes"]` (shape, axis names): this rank's
    (data, model, space) indices and sizes, and the gathered bands of a
    tensor whose rows hold the space rank; on the first, `halo_rows` of
    this rank's band of `inp["x"]` (fp32 and bf16) and `broadcast_space`."""
    out = {"meshes": []}
    for shape, names in inp["meshes"]:
        mesh = M.make_mesh(tuple(shape), tuple(names), device="cpu")
        tag = torch.full((1, 2, 1, 1), float(mesh.space_rank))
        out["meshes"].append({"index": (mesh.rank, mesh.model_rank, mesh.space_rank),
                              "sizes": (mesh.size, mesh.model_size, mesh.space_size), "shape": mesh.shape,
                              "gathered": M.gather_band(tag, mesh)})
        if "x" in inp and "halo" not in out:
            out["halo"] = {str(dt): M.halo_rows(M.local_band(inp["x"].to(dt), mesh), inp["rows"], mesh)
                           for dt in (torch.float32, torch.bfloat16)}
            out["band"] = M.local_band(inp["x"], mesh)
            out["broadcast"] = M.broadcast_space(torch.full((3,), float(rank)).to(torch.bfloat16), mesh)
    return out


def case_sp_serving(inp, rank):
    """`sample_video_sharded` on the mesh `inp["mesh"]` of axes
    `inp["axes"]` (a `space` axis among them) from injected gaussians;
    with `decode`, first the band-mode generator's gathered `compute_fea`
    and `decode_video_with_flow`; then whether train mode is refused."""
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
    from cvpr23_lfdm_torch.models.generator import shard_generator
    from cvpr23_lfdm_torch.parallel.serving import sample_video_sharded

    cfg = inp["cfg"]
    mesh = M.make_mesh(tuple(inp["mesh"]), tuple(inp["axes"]), device="cpu")
    model = FlowDiffusion(cfg.lfae, cfg.diffusion, device="cpu")
    model.load_state_dict(inp["model"])
    out = {"mesh": (mesh.rank, mesh.model_rank, mesh.space_rank, mesh.shape)}
    if "decode" in inp:
        g = shard_generator(model.generator, mesh)
        src, flow, occ = inp["decode"]
        out["fea"] = g.compute_fea(src)
        out["decode"] = g.decode_video_with_flow(src, flow, occ)
    out["out"] = sample_video_sharded(model, mesh, inp["ref"], inp["cond"], 1.0,
                                      init_img=inp["init"], noise_seq=inp["noise"])
    try:
        model.generator.train()
    except ValueError as e:
        out["train_refused"] = str(e)
    return out


CASES = {"basics": case_basics, "mean_grad": case_mean_grad, "replicate": case_replicate,
         "syncbn": case_syncbn, "serving": case_serving, "dm_steps": case_dm_steps,
         "lfae_steps": case_lfae_steps, "tp_meshes": case_tp_meshes, "tp_forms": case_tp_forms, "tp_serving": case_tp_serving,
         "tp_dm_step": case_tp_dm_step, "sp_meshes": case_sp_meshes, "sp_serving": case_sp_serving}


def main(path: str, rank: int) -> None:
    torch.set_num_threads(1)
    spec = torch.load(path, weights_only=False)  # written by the test that spawned this process
    ports, cases, world = spec["ports"], dict(spec["cases"]), spec.get("world", 2)
    cli, tp_cli = cases.pop("cli", None), cases.pop("tp_cli", None)
    results = {}
    D.init_distributed(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=GROUP_TIMEOUT_S)
    try:
        for name, inp in cases.items():
            results[name] = CASES[inp.get("case", name)](inp, rank)
    finally:
        D.shutdown_distributed()
    if cli is not None:
        results["cli"] = case_cli(cli, rank, ports[1:])
    if tp_cli is not None:
        results["tp_cli"] = case_tp_cli(tp_cli, rank, ports[1:], world)
    torch.save(results, os.path.join(os.path.dirname(path), f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
