"""The reference against the port on the CPU at a small size, fp32, with the
same seeded weights: the serving video (the encoder feature, the sampler
through the UNet, the decode) and the DM loss with its gradients."""

from __future__ import annotations

import torch

from portbench.harness import config as hc
from portbench.harness import core
from portbench.harness.weights import seeded_state
from portbench.reference import model as R
from portbench.tests.tiny import OVERRIDES

SEED = 3
F32 = {"unet_dtype": "float32", "lfae_dtype": "float32", "temporal_attn_impl": "xla"}


CONFIGS = {"mug-serve-b32": "mug", "natops-dmtrain-b20": "natops"}


def _exp(workload):
    config = core.load_json(f"{core.HERE}/configs/{CONFIGS[workload]}.json")
    return hc.experiment(config, OVERRIDES[workload])


def _close(a, b, tol):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def test_state_names_match_the_port():
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion

    for workload in OVERRIDES:
        exp = _exp(workload)
        cfg = hc.program_config(exp, F32)
        ref = R.DMTraining(exp)
        prog = FlowDiffusion(cfg.lfae, cfg.diffusion, device="cpu", training=True)
        for n in ("unet", "region_predictor", "bg_predictor", "generator"):
            assert set(getattr(ref, n).state_dict()) == set(getattr(prog, n).state_dict()), n


def test_serving_video_matches_the_port():
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion

    exp = _exp("mug-serve-b32")
    cfg = hc.program_config(exp, {**F32, "sampling_timesteps": 3, "ddim_sampling_eta": 1.0})
    ref = R.Serving(exp)
    prog = FlowDiffusion(cfg.lfae, cfg.diffusion, device="cpu")
    for n in ("unet", "generator"):
        w = seeded_state(getattr(ref, n), SEED, n, "cpu")
        getattr(ref, n).load_state_dict(w)
        getattr(prog, n).load_state_dict(w)
    g = torch.Generator().manual_seed(0)
    d = exp["diffusion"]
    shape = (2, d["num_frames"], d["img_size"], d["img_size"], 3)
    img = torch.rand(2, 32, 32, 3, generator=g)
    cond = torch.randn(2, d["cond_dim"], generator=g)
    init, noise = torch.randn(shape, generator=g), torch.randn((3,) + shape, generator=g)
    with torch.no_grad():
        out = prog.sample_video(img, cond, 1.0, init_img=init, noise_seq=noise)
        latent, video = ref.sample_video(img, cond, init, noise, 3)
    assert _close(torch.cat([out["vid_grid"], out["vid_conf"] * 2 - 1], -1), latent, 1e-4)
    assert _close(out["out_vid"], video, 1e-4)


def test_dm_loss_and_gradient_match_the_port():
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion

    exp = _exp("natops-dmtrain-b20")
    cfg = hc.program_config(exp, F32)
    ref = R.DMTraining(exp)
    prog = FlowDiffusion(cfg.lfae, cfg.diffusion, device="cpu", training=True)
    for n in ("unet", "region_predictor", "bg_predictor", "generator"):
        w = seeded_state(getattr(ref, n), SEED, n, "cpu")
        getattr(ref, n).load_state_dict(w)
        getattr(prog, n).load_state_dict(w)
    g = torch.Generator().manual_seed(1)
    d = exp["diffusion"]
    vid = torch.rand(2, d["num_frames"], 32, 32, 3, generator=g)
    cond = torch.randn(2, d["cond_dim"], generator=g)
    t = torch.tensor([5, 700])
    noise = torch.randn(2, d["num_frames"], d["img_size"], d["img_size"], 3, generator=g)
    null = torch.tensor([True, False])
    loss_p, _ = prog.loss(vid[:, 0], vid, cond, with_monitoring=False, t=t, noise=noise, null_mask=null)
    loss_r = ref.loss(vid[:, 0], vid, cond, t, noise, null)
    assert abs(float(loss_p.detach()) - float(loss_r.detach())) <= 1e-5 * abs(float(loss_r))
    loss_p.backward()
    loss_r.backward()
    for (n, p), r in zip(prog.unet.named_parameters(), ref.unet.parameters()):
        assert _close(p.grad, r.grad, 1e-4), n

