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

Over a mesh the gradients arrive summed over dp already (the trainer
all-reduces them). Parameters sharded over tp (`tp_sharded`) have their
squares summed over `tp_group` for the global norm, and the replicated ones
count once. ZeRO-1 (`zero1` with a dp group of more than one rank; JAX
`fused_optim.py:177-285`): each group's parameters are one flat run of
elements, padded to a multiple of dp, and each dp rank keeps m and v for
its contiguous share of it, updates that share and `all_gather`s the adam
term; the arithmetic per element is the same, so the parameters come out
bit for bit as without it. `state()` gives the whole moments on every
rank in either case, and `load_state` takes them, so a state moves between
world sizes.
"""

from __future__ import annotations

from typing import Collection, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


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
        *,
        dp_group=None,
        zero1: bool = False,
        tp_group=None,
        tp_sharded: Collection[int] = (),
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
        self.tp_group = tp_group
        self.tp_sharded = frozenset(tp_sharded)
        self.dp_group = dp_group
        self.zero1 = bool(zero1) and dp_group is not None and dist.get_world_size(dp_group) > 1
        if self.zero1:  # this rank's share of each group's flat run of elements
            self.dp_rank, self.dp_size = dist.get_rank(dp_group), dist.get_world_size(dp_group)
            self.share = {g: -(-sum(p.numel() for p in ps) // self.dp_size) for g, ps in self.groups.items()}
            self.m = {g: torch.zeros(self.share[g], dtype=moment_dtype, device=ps[0].device)
                      for g, ps in self.groups.items() if g != "frozen"}
            self.v = {g: torch.zeros_like(m) for g, m in self.m.items()}
            return
        self.m = {g: [torch.zeros_like(p, dtype=moment_dtype) for p in ps]
                  for g, ps in self.groups.items() if g != "frozen"}
        self.v = {g: [torch.zeros_like(p, dtype=moment_dtype) for p in ps]
                  for g, ps in self.groups.items() if g != "frozen"}

    @staticmethod
    def _grads(params: List[torch.nn.Parameter]) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]

    def _global_norm(self, grads: Dict[str, List[torch.Tensor]]) -> torch.Tensor:
        flat = [x for xs in grads.values() for x in xs]
        squares = torch.stack(torch._foreach_norm(flat)).square()
        if self.tp_group is None:
            return squares.sum().sqrt()
        params = [p for ps in self.groups.values() for p in ps]
        sharded = torch.tensor([id(p) in self.tp_sharded for p in params], device=squares.device)
        split = torch.where(sharded, squares, 0.0).sum()
        dist.all_reduce(split, group=self.tp_group)
        return (torch.where(sharded, 0.0, squares).sum() + split).sqrt()

    def _flat_share(self, g: str, tensors: List[torch.Tensor]) -> torch.Tensor:
        """This rank's share of a group's tensors laid end to end (ZeRO-1)."""
        flat = torch.cat([x.reshape(-1) for x in tensors])
        share = self.share[g]
        flat = torch.nn.functional.pad(flat, (0, share * self.dp_size - flat.numel()))
        return flat[self.dp_rank * share : (self.dp_rank + 1) * share]

    def _unflatten(self, g: str, flat: torch.Tensor) -> List[torch.Tensor]:
        out, at = [], 0
        for p in self.groups[g]:
            out.append(flat[at : at + p.numel()].view(p.shape))
            at += p.numel()
        return out

    def _gather_share(self, x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(self.dp_size)]
        dist.all_gather(parts, x.contiguous(), group=self.dp_group)
        return torch.cat(parts)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, update every parameter in place from its `.grad`; returns
        the global gradient norm (a device scalar)."""
        grads = {g: self._grads(ps) for g, ps in self.groups.items()}
        norm = self._global_norm(grads)
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
            if self.zero1:
                adam = self._zero1_adam(g, gs, bc1, bc2)
            else:
                m_old = [m.float() for m in self.m[g]]
                v_old = [v.float() for v in self.v[g]]
                m_new = torch._foreach_add(torch._foreach_mul(gs, 1 - b1), torch._foreach_mul(m_old, b1))
                v_new = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2),
                                           torch._foreach_mul(v_old, b2))
                denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v_new, bc2)), self.eps)
                adam = torch._foreach_div(torch._foreach_div(m_new, bc1), denom)
                torch._foreach_copy_(self.m[g], m_new)  # rounds to bf16 when the moments are stored so
                torch._foreach_copy_(self.v[g], v_new)
            if wd:
                adam = torch._foreach_add(adam, torch._foreach_mul(params, wd))
            torch._foreach_add_(params, torch._foreach_mul(adam, -lr))
        return norm

    def _zero1_adam(self, g: str, gs: List[torch.Tensor], bc1: float, bc2: float) -> List[torch.Tensor]:
        """The adam term of group g, each rank computing its share from its
        moments (the same per-element arithmetic as `step`), gathered."""
        b1, b2 = self.b1, self.b2
        local = self._flat_share(g, gs)
        m_new = local * (1 - b1) + self.m[g].float() * b1
        v_new = (local * local) * (1 - b2) + self.v[g].float() * b2
        adam = (m_new / bc1) / ((v_new / bc2).sqrt() + self.eps)
        self.m[g].copy_(m_new)
        self.v[g].copy_(v_new)
        full = self._gather_share(adam)
        return self._unflatten(g, full)

    def zero_grad(self) -> None:
        for ps in self.groups.values():
            for p in ps:
                p.grad = None

    def _moments(self, which: Dict) -> Dict[str, List[torch.Tensor]]:
        """The moments per group as one tensor per parameter (under ZeRO-1
        the shares gathered from every dp rank: a collective)."""
        if not self.zero1:
            return which
        return {g: self._unflatten(g, self._gather_share(x)) for g, x in which.items()}

    def state(self) -> Dict:
        """count and the moments, per group, one CPU tensor per parameter
        (under ZeRO-1 every dp rank must call it)."""
        return {
            "count": self.count,
            "m": {g: [x.detach().cpu() for x in xs] for g, xs in self._moments(self.m).items()},
            "v": {g: [x.detach().cpu() for x in xs] for g, xs in self._moments(self.v).items()},
        }

    @torch.no_grad()
    def load_state(self, state: Dict) -> None:
        """Restore what `state()` returned, into the moments in place."""
        self.count = int(state["count"])
        for key, dst in (("m", self.m), ("v", self.v)):
            sizes = {g: len(self.groups[g]) for g in dst}
            if set(state[key]) != set(dst) or any(len(state[key][g]) != n for g, n in sizes.items()):
                raise ValueError(f"optimizer state {key}: groups {sorted(state[key])} do not match {sorted(dst)}")
            if self.zero1:
                for g, x in dst.items():
                    x.copy_(self._flat_share(g, [y.to(x.device) for y in state[key][g]]))
                continue
            for g, xs in dst.items():
                for x, y in zip(xs, state[key][g]):
                    x.copy_(y)


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
