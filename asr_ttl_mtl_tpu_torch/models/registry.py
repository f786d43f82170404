"""The model container, random initialization, checkpoint load and the
weight carry from the JAX package.

Counterpart of `asr_ttl_mtl_tpu/models/registry.py`. The `.pt` layout is
the reference's (`{"dims": {...}, "model_state_dict": {...}}`), and
`state_dict_from_jax_params` gives exactly the keys, transposes and shapes
of the JAX package's `export_torch_state_dict` (:168-223) from a tree of
numpy arrays, without importing jax. Downloading official checkpoints is
not ported: `load_model` reads local files.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..utils import resolve_device
from .dims import PRESET_DIMS, ModelDimensions
from .whisper import AudioEncoder, TextDecoder, sinusoids


class WhisperModel(nn.Module):
    """Encoder + decoder modules, the dims, and the compute dtype (the
    parameters stay fp32, as the JAX masters do)."""

    def __init__(self, dims: ModelDimensions, compute_dtype: torch.dtype = torch.float32, name: str = ""):
        super().__init__()
        self.dims = dims
        self.encoder = AudioEncoder(dims)
        self.decoder = TextDecoder(dims)
        self.compute_dtype = compute_dtype
        self.name = name

    @property
    def device(self) -> torch.device:
        return self.decoder.token_embedding.weight.device

    @property
    def has_disease_tokens(self) -> bool:
        """Vocab expanded with the disease tokens (51864->51868 en-only,
        51865->51869 multilingual, SURVEY.md §5 item 3)."""
        return self.dims.n_vocab in (51868, 51869)

    @property
    def is_multilingual(self) -> bool:
        if self.has_disease_tokens:
            return self.dims.n_vocab == 51869
        return self.dims.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        if self.has_disease_tokens:
            return 99
        return self.dims.n_vocab - 51765 - int(self.is_multilingual)

    def resize_token_embeddings(self, new_vocab_size: int, generator: torch.Generator) -> None:
        """Grow the tied token embedding to fit the spliced disease tokens
        (JAX `models/whisper.py::resize_token_embeddings`): new rows are
        N(0, std of the existing rows), drawn from `generator` (the JAX
        package draws other numbers from its own key)."""
        old = self.decoder.token_embedding.weight
        cur = old.shape[0]
        if new_vocab_size == cur:
            return
        assert new_vocab_size > cur, (new_vocab_size, cur)
        with torch.no_grad():
            std = old.float().std(unbiased=False)
            rows = torch.randn((new_vocab_size - cur, old.shape[1]), generator=generator,
                               device=generator.device, dtype=torch.float32)
            weight = torch.cat([old.float(), rows.to(old.device) * std]).to(old.dtype)
        self.decoder.token_embedding = nn.Embedding.from_pretrained(weight, freeze=not old.requires_grad)
        self.dims = self.dims.replace(n_vocab=new_vocab_size)
        self.encoder.dims = self.decoder.dims = self.dims


def _init_random_(model: WhisperModel, gen: torch.Generator) -> None:
    """Fan-in uniform init like the JAX package's `init_params` (same
    distributions, other numbers): U(+-1/sqrt(fan_in)) for linears and
    convs, LayerNorm 1/0, token embedding N(0, 0.02), positions N(0, 0.01)."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Conv1d)):
                fan_in = module.weight[0].numel()
                bound = 1.0 / np.sqrt(fan_in)
                module.weight.uniform_(-bound, bound, generator=gen)
                if module.bias is not None:
                    module.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.fill_(0.0)
        model.decoder.token_embedding.weight.normal_(0.0, 0.02, generator=gen)
        model.decoder.positional_embedding.normal_(0.0, 0.01, generator=gen)


def from_random(
    name_or_dims: Union[str, ModelDimensions],
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float32,
) -> WhisperModel:
    """Randomly initialized model from a seed (tests and benchmarks without
    weights), on the card unless `device="cpu"`; `dtype` is the compute
    dtype (bf16 on the card)."""
    device = resolve_device(device)
    dims = PRESET_DIMS[name_or_dims] if isinstance(name_or_dims, str) else name_or_dims
    name = name_or_dims if isinstance(name_or_dims, str) else "custom"
    model = WhisperModel(dims, compute_dtype=dtype, name=name)
    _init_random_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval().requires_grad_(False)


def load_model(
    checkpoint: Union[str, Dict[str, Any]],
    device: Union[str, torch.device] = "cuda",
    compute_dtype: Optional[torch.dtype] = None,
) -> WhisperModel:
    """Load a reference-layout checkpoint (a local `.pt` path or the loaded
    dict), on the card unless `device="cpu"`."""
    device = resolve_device(device)
    ckpt = checkpoint
    if isinstance(checkpoint, str):
        ckpt = torch.load(checkpoint, map_location="cpu", weights_only=False)
    dims = ckpt["dims"]
    dims = ModelDimensions(**dims) if isinstance(dims, dict) else dims
    if compute_dtype is None:
        compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = WhisperModel(dims, compute_dtype=compute_dtype)
    model.load_state_dict({k: v.float() for k, v in ckpt["model_state_dict"].items()})
    return model.to(device).eval().requires_grad_(False)


def state_dict_from_jax_params(params: Dict[str, Any], dims: ModelDimensions) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (leaves as numpy arrays) -> reference state dict:
    linear weights (in, out) -> (out, in), conv weights as they are,
    LayerNorm scale/bias -> weight/bias, plus the encoder's sinusoids."""
    sd: Dict[str, torch.Tensor] = {}

    def put(name, arr, transpose=False):
        a = np.asarray(arr)
        if transpose:
            a = a.T
        sd[name] = torch.from_numpy(np.array(a, copy=True, order="C"))

    def lin(prefix, p):
        put(f"{prefix}.weight", p["w"], transpose=True)
        if "b" in p:
            put(f"{prefix}.bias", p["b"])

    def ln(prefix, p):
        put(f"{prefix}.weight", p["scale"])
        put(f"{prefix}.bias", p["bias"])

    def attn(prefix, p):
        for name in ("query", "key", "value", "out"):
            lin(f"{prefix}.{name}", p[name])

    enc = params["encoder"]
    put("encoder.conv1.weight", enc["conv1"]["w"])
    put("encoder.conv1.bias", enc["conv1"]["b"])
    put("encoder.conv2.weight", enc["conv2"]["w"])
    put("encoder.conv2.bias", enc["conv2"]["b"])
    put("encoder.positional_embedding", sinusoids(dims.n_audio_ctx, dims.n_audio_state))
    for i, b in enumerate(enc["blocks"]):
        attn(f"encoder.blocks.{i}.attn", b["attn"])
        ln(f"encoder.blocks.{i}.attn_ln", b["attn_ln"])
        lin(f"encoder.blocks.{i}.mlp.0", b["mlp"]["fc1"])
        lin(f"encoder.blocks.{i}.mlp.2", b["mlp"]["fc2"])
        ln(f"encoder.blocks.{i}.mlp_ln", b["mlp_ln"])
    ln("encoder.ln_post", enc["ln_post"])

    dec = params["decoder"]
    put("decoder.token_embedding.weight", dec["token_embedding"])
    put("decoder.positional_embedding", dec["positional_embedding"])
    for i, b in enumerate(dec["blocks"]):
        attn(f"decoder.blocks.{i}.attn", b["attn"])
        ln(f"decoder.blocks.{i}.attn_ln", b["attn_ln"])
        attn(f"decoder.blocks.{i}.cross_attn", b["cross_attn"])
        ln(f"decoder.blocks.{i}.cross_attn_ln", b["cross_attn_ln"])
        lin(f"decoder.blocks.{i}.mlp.0", b["mlp"]["fc1"])
        lin(f"decoder.blocks.{i}.mlp.2", b["mlp"]["fc2"])
        ln(f"decoder.blocks.{i}.mlp_ln", b["mlp_ln"])
    ln("decoder.ln", dec["ln"])
    return sd
