"""The model container, random initialization, checkpoint load and the
weight carry from the JAX package.

Counterpart of `asr_ttl_mtl_tpu/models/registry.py`. The `.pt` layout is
the reference's (`{"dims": {...}, "model_state_dict": {...}}`), and
`state_dict_from_jax_params` gives exactly the keys, transposes and shapes
of the JAX package's `export_torch_state_dict` (:168-223) from a tree of
numpy arrays, without importing jax. `available_models()` (JAX :73) names
the official checkpoints, and `load_model(name)` finds one on the disk by
the JAX package's search (`_find_cached_checkpoint`, :364: the same file
names, places and SHA-256 check); nothing is downloaded, so a name whose
file is absent raises the JAX package's "not found" message. The
alignment-head masks of the official checkpoints (`_ALIGNMENT_HEADS`, for
word timestamps) and their hashes are data kept here.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..utils import resolve_device
from .dims import PRESET_DIMS, ModelDimensions
from .whisper import AudioEncoder, TextDecoder, decode_alignment_heads_dump, default_alignment_heads, sinusoids

# SHA-256 of the official checkpoints, by name (the JAX package's
# `models/registry.py:30-45`, public registry data); "large" and "turbo"
# name the files of large-v3 and large-v3-turbo
_CHECKPOINT_SHAS = {
    "tiny.en": "d3dd57d32accea0b295c96e26691aa14d8822fac7d9d27d5dc00b4ca2826dd03",
    "tiny": "65147644a518d12f04e32d6f3b26facc3f8dd46e5390956a9424a650c0ce22b9",
    "base.en": "25a8566e1d0c1e2231d1c762132cd20e0f96a85d16145c3a00adf5d1ac670ead",
    "base": "ed3a0b6b1c0edf879ad9b11b1af5a0e6ab5db9205f891f668f8b0e6c6326e34e",
    "small.en": "f953ad0fd29cacd07d5a9eda5624af0f6bcf2258be67c92b79389873d91e0872",
    "small": "9ecf779972d90ba49c06d968637d720dd632c55bbf19d441fb42bf17a411e794",
    "medium.en": "d7440d1dc186f76616474e0ff0b3b6b879abc9d1a4926b7adfa41db2d497ab4f",
    "medium": "345ae4da62f9b3d59415adc60127b97c714f32e89e936602e85993674d08dcb1",
    "large-v1": "e4b87e7e0bf463eb8e6956e646f1e277e901512310def2c24bf0e11bd3c28e9a",
    "large-v2": "81f7c96c852ee8fc832187b0132e569d6c3065a3252ed18e56effd0b6a73e524",
    "large-v3": "e5b1a55b89c1367dacf97e3e19bfd829a01529dbfdeefa8caeb59b3f1b81dadb",
    "large": "e5b1a55b89c1367dacf97e3e19bfd829a01529dbfdeefa8caeb59b3f1b81dadb",
    "large-v3-turbo": "aff26ae408abcba5fbf8813c21e62b0941638c5f6eebfb145be0c9839262a19a",
    "turbo": "aff26ae408abcba5fbf8813c21e62b0941638c5f6eebfb145be0c9839262a19a",
}
_ALIASES = {"large": "large-v3", "turbo": "large-v3-turbo"}
_FILE_NAMES = {name: _ALIASES.get(name, name) + ".pt" for name in _CHECKPOINT_SHAS}


def available_models() -> List[str]:
    """Names of the official checkpoints (JAX `available_models`); the
    port finds them on the disk and downloads none."""
    return list(_CHECKPOINT_SHAS)


def default_download_root() -> str:
    """The JAX package's checkpoint directory: $XDG_CACHE_HOME (or
    ~/.cache)/asr_ttl_mtl_tpu."""
    default = os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(os.getenv("XDG_CACHE_HOME", default), "asr_ttl_mtl_tpu")


def _find_cached_checkpoint(name: str, download_root: str) -> Optional[str]:
    """The first of $ASRMTL_CHECKPOINT_DIR/<file>, <download_root>/<file>
    and ~/.cache/whisper/<file> whose SHA-256 is the official one."""
    fname = _FILE_NAMES[name]
    candidates = [
        os.path.join(download_root, fname),
        os.path.join(os.path.expanduser("~"), ".cache", "whisper", fname),
    ]
    if os.environ.get("ASRMTL_CHECKPOINT_DIR"):
        candidates.insert(0, os.path.join(os.environ["ASRMTL_CHECKPOINT_DIR"], fname))
    for c in candidates:
        if os.path.isfile(c):
            with open(c, "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() == _CHECKPOINT_SHAS[name]:
                    return c
    return None


# base85/gzip-encoded (n_text_layer, n_text_head) bool masks of the
# cross-attention heads that word timestamps read, per official checkpoint
# (the JAX package's `models/registry.py:55-70`, public registry data)
_ALIGNMENT_HEADS = {
    "tiny.en": b"ABzY8J1N>@0{>%R00Bk>$p{7v037`oCl~+#00",
    "tiny": b"ABzY8bu8Lr0{>%RKn9Fp%m@SkK7Kt=7ytkO",
    "base.en": b"ABzY8;40c<0{>%RzzG;p*o+Vo09|#PsxSZm00",
    "base": b"ABzY8KQ!870{>%RzyTQH3`Q^yNP!>##QT-<FaQ7m",
    "small.en": b"ABzY8>?_)10{>%RpeA61k&I|OI3I$65C{;;pbCHh0B{qLQ;+}v00",
    "small": b"ABzY8DmU6=0{>%Rpa?J`kvJ6qF(V^F86#Xh7JUGMK}P<N0000",
    "medium.en": b"ABzY8usPae0{>%R7<zz_OvQ{)4kMa0BMw6u5rT}kRKX;$NfYBv00*Hl@qhsU00",
    "medium": b"ABzY8B0Jh+0{>%R7}kK1fFL7w6%<-Pf*t^=N)Qr&0RR9",
    "large-v1": b"ABzY8r9j$a0{>%R7#4sLmoOs{s)o3~84-RPdcFk!JR<kSfC2yj",
    "large-v2": b"ABzY8zd+h!0{>%R7=D0pU<_bnWW*tkYAhobTNnu$jnkEkXqp)j;w1Tzk)UH3X%SZd&fFZ2fC2yj",
    "large-v3": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
    "large": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
    "large-v3-turbo": b"ABzY8j^C+e0{>%RARaKHP%t(lGR*)0g!tONPyhe`",
    "turbo": b"ABzY8j^C+e0{>%RARaKHP%t(lGR*)0g!tONPyhe`",
}


class WhisperModel(nn.Module):
    """Encoder + decoder modules, the dims, the compute dtype (the
    parameters stay fp32, as the JAX masters do) and the alignment heads,
    a bool (n_text_layer, n_text_head) numpy mask of the cross-attention
    heads word timestamps read (by default every head of the last half of
    the layers)."""

    def __init__(self, dims: ModelDimensions, compute_dtype: torch.dtype = torch.float32, name: str = ""):
        super().__init__()
        self.dims = dims
        self.encoder = AudioEncoder(dims)
        self.decoder = TextDecoder(dims)
        self.compute_dtype = compute_dtype
        self.name = name
        self.alignment_heads = default_alignment_heads(dims)

    def set_alignment_heads(self, dump: bytes) -> None:
        """Set the alignment heads from a base85/gzip mask (`_ALIGNMENT_HEADS`)."""
        self.alignment_heads = decode_alignment_heads_dump(self.dims, dump)

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

    # --- the reference's high-level API (late imports avoid cycles) ---

    def decode(self, mel, options=None, **kwargs):
        from ..decoding import decode

        return decode(self, mel, options, **kwargs)

    def detect_language(self, mel, tokenizer=None):
        from ..decoding import detect_language

        return detect_language(self, mel, tokenizer)

    def transcribe(self, audio, **kwargs):
        from ..transcribe import transcribe

        return transcribe(self, audio, **kwargs)


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
    download_root: Optional[str] = None,
) -> WhisperModel:
    """Load a reference-layout checkpoint, on the card unless
    `device="cpu"`: a local `.pt` path, the loaded dict, or the name of an
    official checkpoint found on the disk (`_find_cached_checkpoint`, which
    also sets its alignment heads)."""
    device = resolve_device(device)
    ckpt = checkpoint
    alignment_dump = None
    if isinstance(checkpoint, str):
        path = checkpoint
        if checkpoint in _CHECKPOINT_SHAS:
            path = _find_cached_checkpoint(checkpoint, download_root or default_download_root())
            if path is None:
                raise RuntimeError(f"Model {checkpoint} not found; available models = {available_models()}")
            alignment_dump = _ALIGNMENT_HEADS[checkpoint]
        elif not os.path.isfile(checkpoint):
            raise RuntimeError(f"Model {checkpoint} not found; available models = {available_models()}")
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    dims = ckpt["dims"]
    dims = ModelDimensions(**dims) if isinstance(dims, dict) else dims
    if compute_dtype is None:
        compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = WhisperModel(dims, compute_dtype=compute_dtype)
    model.load_state_dict({k: v.float() for k, v in ckpt["model_state_dict"].items()})
    if alignment_dump is not None:
        model.set_alignment_heads(alignment_dump)
    return model.to(device).eval().requires_grad_(False)


def checkpoint_dict(model: WhisperModel) -> Dict[str, Any]:
    """The reference `.pt` layout of a model, for `torch.save`: its dims and
    its fp32 state dict on the CPU; `load_model` reads it back."""
    return {
        "dims": dict(model.dims.__dict__),
        "model_state_dict": {k: v.detach().float().cpu() for k, v in model.state_dict().items()},
    }


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
