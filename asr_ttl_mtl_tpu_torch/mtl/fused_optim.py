"""Global-norm gradient clipping and the 4-group AdamW of the fine-tune.

Counterpart of `asr_ttl_mtl_tpu/mtl/fused_optim.py::fused_multigroup_adamw`
(:169), which is arithmetically the optax chain
`clip_by_global_norm(c)` + `multi_transform({group: adamw(lr_g, wd_g)})`.
Written by hand rather than with `torch.optim.AdamW`, whose decoupled decay
(p *= 1 - lr wd, before the Adam step) rounds differently. Per element, in
the JAX order:

    norm  = sqrt(sum over every gradient of |g|^2)
    g     = g                        if norm < c else (g / norm) * c
    m     = (1 - b1) g + b1 m        v = (1 - b2) g^2 + b2 v
    adam  = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)
    p     = p + (-lr_g) (adam + wd_g p)          (the wd term only if wd_g)

with the moments in fp32, or stored in bf16 (`moment_dtype`; the math
still runs in fp32 from the upcast moments and only the store rounds).
Parameters in the "frozen" group get no update and no state. The update
runs on the parameters' device with `torch._foreach_*` lists per group;
nothing here waits for the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch


class MultiGroupAdamW:
    """`groups`: group -> list of parameters; `hparams`: group ->
    (learning_rate, weight_decay). Groups named "frozen" are left alone."""

    def __init__(
        self,
        groups: Dict[str, Sequence[torch.nn.Parameter]],
        hparams: Dict[str, Tuple[float, float]],
        clip_norm: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        moment_dtype: torch.dtype = torch.float32,
    ):
        self.groups = {g: list(ps) for g, ps in groups.items() if ps}
        for g in self.groups:
            if g != "frozen" and g not in hparams:
                raise ValueError(f"unknown optimizer group {g!r}")
        self.hparams = dict(hparams)
        self.clip_norm = float(clip_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.moment_dtype = moment_dtype
        self.count = 0
        self.m = {g: [torch.zeros_like(p, dtype=moment_dtype) for p in ps]
                  for g, ps in self.groups.items() if g != "frozen"}
        self.v = {g: [torch.zeros_like(p, dtype=moment_dtype) for p in ps]
                  for g, ps in self.groups.items() if g != "frozen"}

    @staticmethod
    def _grads(params: List[torch.nn.Parameter]) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, update every parameter in place from its `.grad`; returns
        the global gradient norm (a device scalar)."""
        grads = {g: self._grads(ps) for g, ps in self.groups.items()}
        norm = torch.stack(torch._foreach_norm([x for xs in grads.values() for x in xs])).square().sum().sqrt()
        trigger = norm < self.clip_norm
        self.count += 1
        b1, b2 = self.b1, self.b2
        # bias corrections in fp32, as the JAX update forms them
        t = torch.tensor(float(self.count), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
        for g, params in self.groups.items():
            if g == "frozen":
                continue
            lr, wd = self.hparams[g]
            gs = [torch.where(trigger, x, (x / norm) * self.clip_norm) for x in grads[g]]
            m_old = [m.float() for m in self.m[g]]
            v_old = [v.float() for v in self.v[g]]
            m_new = torch._foreach_add(torch._foreach_mul(gs, 1 - b1), torch._foreach_mul(m_old, b1))
            v_new = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2),
                                       torch._foreach_mul(v_old, b2))
            denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v_new, bc2)), self.eps)
            adam = torch._foreach_div(torch._foreach_div(m_new, bc1), denom)
            if wd:
                adam = torch._foreach_add(adam, torch._foreach_mul(params, wd))
            torch._foreach_add_(params, torch._foreach_mul(adam, -lr))
            torch._foreach_copy_(self.m[g], m_new)  # rounds to bf16 when the moments are stored so
            torch._foreach_copy_(self.v[g], v_new)
        return norm

    def zero_grad(self) -> None:
        for ps in self.groups.values():
            for p in ps:
                p.grad = None

    def state(self) -> Dict:
        """count and the moments, per group (CPU tensors)."""
        return {
            "count": self.count,
            "m": {g: [x.detach().cpu() for x in xs] for g, xs in self.m.items()},
            "v": {g: [x.detach().cpu() for x in xs] for g, xs in self.v.items()},
        }


def optimizer_hparams(learning_rate: float, weight_decay: float) -> Dict[str, Tuple[float, float]]:
    """encoder 0.1 lr, decoder 0.3 lr, embeddings 1.0 lr without decay,
    classifier 1.0 lr (reference trainer.py:139-198)."""
    lr, wd = learning_rate, weight_decay
    return {
        "encoder": (lr * 0.1, wd),
        "decoder": (lr * 0.3, wd),
        "embeddings": (lr * 1.0, 0.0),
        "classifier": (lr * 1.0, wd),
    }


def group_of(name: str, freeze_encoder: bool = False) -> Optional[str]:
    """Group of a named parameter of {"model": WhisperModel, "classifier": ...}."""
    if name.startswith("classifier."):
        return "classifier"
    if name.startswith("model.encoder."):
        return "frozen" if freeze_encoder else "encoder"
    if name.startswith("model.decoder.token_embedding."):
        return "embeddings"
    if name.startswith("model.decoder."):
        return "decoder"
    return None
