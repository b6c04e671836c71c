"""Super-SloMo training in plain PyTorch: the batch sampler, the losses
and Adam.

Sampling (v2e's train_slomo tool, whose schedule the port keeps): from a
numpy default_rng(seed), per sample a clip index, a start frame s, an
interior offset k in [1, gap], a crop corner y then x; I0 = frame s, It =
frame s + k at t = k / (gap + 1), I1 = frame s + gap + 1, each scaled to
0-1 with the mean 0.428 taken off.  A clip too short or too small for the
crop is skipped (its draws taken).  The clips are decoded with cv2 and
converted to gray, as train_slomo does.

Losses (Jiang et al., CVPR 2018, eq. 7-11, without the perceptual term, as
the port and the JAX package train): 204 L1(It_hat, It) + 102 (L1 of the
four warps: I1 by F_0_1 to I0, I0 by F_1_0 to I1, I0 by F_t_0 and I1 by
F_t_1 to It) + the total variation of F_0_1 and F_1_0.  The blend's
denominator carries 1e-8.

Adam (Kingma and Ba): m = 0.9 m + 0.1 g, v = 0.999 v + 0.001 g^2,
p -= lr (m / (1 - 0.9^n)) / (sqrt(v / (1 - 0.999^n)) + 1e-8).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference.slomo import MEAN, backwarp, no_tf32, unet

LAMBDA_R, LAMBDA_W, LAMBDA_S = 204.0, 102.0, 1.0
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def decode_gray(path: str) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(fr, cv2.COLOR_BGR2GRAY))
    cap.release()
    return np.stack(frames)


def sample_batches(clips: List[np.ndarray], crop, gap: int, seed: int, batch: int, n: int):
    """The first `n` batches train_slomo's sampler draws from `seed`."""
    rng = np.random.default_rng(seed)
    ch, cw = crop
    out = []
    for _ in range(n):
        I0 = np.empty((batch, 1, ch, cw), np.float32)
        It, I1 = np.empty_like(I0), np.empty_like(I0)
        t = np.empty((batch,), np.float32)
        i = 0
        while i < batch:
            frames = clips[rng.integers(len(clips))]
            if frames.shape[0] < gap + 2:
                continue
            H, W = frames.shape[1:]
            if H < ch or W < cw:
                continue
            s = int(rng.integers(0, frames.shape[0] - gap - 1))
            k = int(rng.integers(1, gap + 1))
            y = int(rng.integers(0, H - ch + 1))
            x = int(rng.integers(0, W - cw + 1))
            I0[i, 0] = frames[s, y:y + ch, x:x + cw]
            It[i, 0] = frames[s + k, y:y + ch, x:x + cw]
            I1[i, 0] = frames[s + gap + 1, y:y + ch, x:x + cw]
            t[i] = k / (gap + 1)
            i += 1
        out.append({"I0": I0 / 255.0 - MEAN, "I1": I1 / 255.0 - MEAN,
                    "It": It / 255.0 - MEAN, "t": t})
    return out


def _tv(x):
    return (x[..., 1:, :] - x[..., :-1, :]).abs().mean() + (x[..., :, 1:] - x[..., :, :-1]).abs().mean()


def loss(flow_w, interp_w, b: Dict[str, torch.Tensor], precision: str = "f32"):
    """(total, {"loss", "l_r", "l_w", "l_s"}) of one batch."""
    I0, I1, It, t = b["I0"], b["I1"], b["It"], b["t"]
    flow = unet(flow_w, torch.cat([I0, I1], dim=1), precision)
    F01, F10 = flow[:, :2], flow[:, 2:]
    tb = t[:, None, None, None]
    Ft0 = -(1 - tb) * tb * F01 + tb * tb * F10
    Ft1 = (1 - tb) * (1 - tb) * F01 - tb * (1 - tb) * F10
    g0, g1 = backwarp(I0, Ft0), backwarp(I1, Ft1)
    r = unet(interp_w, torch.cat([I0, I1, F01, F10, Ft1, Ft0, g1, g0], dim=1), precision)
    Ft0f, Ft1f = r[:, 0:2] + Ft0, r[:, 2:4] + Ft1
    V0 = torch.sigmoid(r[:, 4:5])
    V1 = 1 - V0
    g0f, g1f = backwarp(I0, Ft0f), backwarp(I1, Ft1f)
    w0, w1 = (1 - tb) * V0, tb * V1
    It_hat = (w0 * g0f + w1 * g1f) / (w0 + w1 + 1e-8)
    l_r = (It_hat - It).abs().mean()
    l_w = ((backwarp(I1, F01) - I0).abs().mean() + (backwarp(I0, F10) - I1).abs().mean()
           + (g0 - It).abs().mean() + (g1 - It).abs().mean())
    l_s = _tv(F01) + _tv(F10)
    total = LAMBDA_R * l_r + LAMBDA_W * l_w + LAMBDA_S * l_s
    return total, {"loss": total, "l_r": l_r, "l_w": l_w, "l_s": l_s}


def train(flow_w, interp_w, batches, lr: float, device, precision: str = "f32"):
    """Adam on the losses of `batches`, from float32 copies of the weights.

    Returns {"loss": [per step], "grad1": {leaf: gradient of step 1},
    "params0": {leaf: start}, "params": {leaf: after the last step}};
    leaves are named "<net>/<layer>.weight" and ".bias"."""
    params = {}
    for net, ws in (("flow", flow_w), ("interp", interp_w)):
        for name, (w, b) in ws.items():
            params[f"{net}/{name}.weight"] = w.detach().to(device, torch.float32).clone().requires_grad_(True)
            params[f"{net}/{name}.bias"] = b.detach().to(device, torch.float32).clone().requires_grad_(True)
    start = {k: v.detach().clone() for k, v in params.items()}

    def net_weights(net):
        names = {k.split("/", 1)[1].rsplit(".", 1)[0] for k in params if k.startswith(net + "/")}
        return {n: (params[f"{net}/{n}.weight"], params[f"{net}/{n}.bias"]) for n in names}

    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad1 = [], None
    with no_tf32():
        for step, batch in enumerate(batches, 1):
            bt = {k: torch.as_tensor(np.asarray(x)).to(device, torch.float32) for k, x in batch.items()}
            total, terms = loss(net_weights("flow"), net_weights("interp"), bt, precision)
            grads = torch.autograd.grad(total, list(params.values()))
            losses.append({k: float(x.detach()) for k, x in terms.items()})
            if step == 1:
                grad1 = {k: g.detach().clone() for k, g in zip(params, grads)}
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                    v2[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                    mh = m[k] / (1 - BETA1 ** step)
                    vh = v2[k] / (1 - BETA2 ** step)
                    p.sub_(lr * mh / (vh.sqrt() + EPS))
    return {"loss": losses, "grad1": grad1, "params0": start,
            "params": {k: v.detach() for k, v in params.items()}}
