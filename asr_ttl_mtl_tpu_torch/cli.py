"""Command-line transcription (counterpart of `asr_ttl_mtl_tpu/cli.py`).

    python -m asr_ttl_mtl_tpu_torch audio.wav --model base.pt [--device cpu] ...

The flags, defaults and their rules are the JAX package's. `--model` names
a reference-layout `.pt` file, a preset name whose `<name>.pt` lies in
`--model_dir`, or an official checkpoint (`models.available_models()`,
JAX `cli.py:23-29`) found where the JAX package keeps them: nothing is
downloaded. A preset name also sets that preset's
alignment heads for `--word_timestamps`, as the JAX `load_model` does
(when the checkpoint has the preset's decoder layers and heads). `--device` is a torch device, the
card by default. `--batch_mode True` decodes every window of every file
in batches through `transcribe_batch`; its options are routed as in JAX
`cli.py:141-202`. With `--batch_mode`, `--dp` and `--tp` decode over a
("dp", "tp") mesh of ranks, one process per rank, as torchrun starts them:

    torchrun --nproc_per_node 2 -m asr_ttl_mtl_tpu_torch a.wav b.wav --model base.pt \
        --batch_mode True --dp 2

Each rank takes the card of its LOCAL_RANK and joins the process group
from torchrun's environment (NCCL on the card, gloo on the CPU), or the
one its caller initialized; rank 0 alone writes the outputs. Without
`--batch_mode` the two flags are ignored, as in JAX.
"""

from __future__ import annotations

import argparse
import inspect
import os
import traceback
import warnings
from typing import List, Optional

import numpy as np

from .tokenizer import LANGUAGES, TO_LANGUAGE_CODE
from .utils import optional_float, optional_int, str2bool
from .utils.writers import get_writer


def build_parser() -> argparse.ArgumentParser:
    """The transcription flag surface, separate from `cli` so that it can be
    tested."""
    from .models import PRESET_DIMS, available_models

    def valid_model_name(name):
        if name in available_models() or name in PRESET_DIMS or os.path.exists(name):
            return name
        raise ValueError(f"model should be one of {available_models()} or path to a model checkpoint")

    # fmt: off
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("audio", nargs="+", type=str, help="audio file(s) to transcribe")
    parser.add_argument("--model", default="turbo", type=valid_model_name, help="a reference-layout .pt checkpoint, or a preset name whose <name>.pt lies in --model_dir")
    parser.add_argument("--model_dir", type=str, default=None, help="directory holding <name>.pt checkpoints for preset names; nothing is downloaded")
    parser.add_argument("--device", default="cuda", help="torch device to run on ('cuda' or 'cpu')")
    parser.add_argument("--output_dir", "-o", type=str, default=".", help="directory to save the outputs")
    parser.add_argument("--output_format", "-f", type=str, default="all", choices=["txt", "vtt", "srt", "tsv", "json", "all"], help="format of the output file; if not specified, all available formats will be produced")
    parser.add_argument("--verbose", type=str2bool, default=True, help="whether to print out progress and debug messages")

    parser.add_argument("--task", type=str, default="transcribe", choices=["transcribe", "translate"], help="perform X->X speech recognition ('transcribe') or X->English translation ('translate')")
    parser.add_argument("--language", type=str, default=None, choices=sorted(LANGUAGES.keys()) + sorted([k.title() for k in TO_LANGUAGE_CODE.keys()]), help="language spoken in the audio; None performs language detection")

    parser.add_argument("--temperature", type=float, default=0, help="temperature to use for sampling")
    parser.add_argument("--best_of", type=optional_int, default=5, help="number of candidates when sampling with non-zero temperature")
    parser.add_argument("--beam_size", type=optional_int, default=5, help="number of beams in beam search, only applicable when temperature is zero")
    parser.add_argument("--patience", type=float, default=None, help="optional patience value in beam decoding (arXiv:2204.05424); 1.0 is conventional beam search")
    parser.add_argument("--length_penalty", type=float, default=None, help="optional token length penalty coefficient (alpha, arXiv:1609.08144); simple length normalization by default")

    parser.add_argument("--suppress_tokens", type=str, default="-1", help="comma-separated token ids to suppress; '-1' suppresses most special characters except common punctuation")
    parser.add_argument("--initial_prompt", type=str, default=None, help="optional text to provide as a prompt for the first window")
    parser.add_argument("--carry_initial_prompt", type=str2bool, default=False, help="prepend initial_prompt to every internal decode() call")

    parser.add_argument("--condition_on_previous_text", type=str2bool, default=True, help="provide the previous output as a prompt for the next window")
    parser.add_argument("--fp16", type=str2bool, default=True, help="use the fast half-precision compute dtype (bf16 on the card); False decodes in fp32, on the card through its fp32 kernels")
    parser.add_argument("--kv_int8", type=str2bool, default=False, help="store the attention K/V caches int8 (per-row scales): faster batched decoding, approximately identical output")
    parser.add_argument("--int8_encoder", type=str2bool, default=False, help="run the encoder block projections as dynamically-quantized int8 matmuls: faster encoding, approximately identical output")
    parser.add_argument("--fuse_encoder", type=str2bool, default=True, help="with --kv_int8, let the prompt prefill read the float cross K/V (the JAX package's fused window program); False reads the dequantized int8 store")
    parser.add_argument("--batch_mode", type=str2bool, default=False, help="decode every 30s window of every input file in device-wide batches (throughput mode; windows are decoded independently)")
    parser.add_argument("--dp", type=optional_int, default=None, help="with --batch_mode: shard window batches data-parallel over this many ranks (0: all the ranks tp leaves); default: one process")
    parser.add_argument("--tp", type=optional_int, default=None, help="with --batch_mode: additionally shard the model weights tensor-parallel over this many ranks per dp replica (Megatron layout)")

    parser.add_argument("--temperature_increment_on_fallback", type=optional_float, default=0.2, help="temperature increment on decode-quality fallback")
    parser.add_argument("--compression_ratio_threshold", type=optional_float, default=2.4, help="gzip compression ratio above which a decode is treated as failed")
    parser.add_argument("--logprob_threshold", type=optional_float, default=-1.0, help="average log probability below which a decode is treated as failed")
    parser.add_argument("--no_speech_threshold", type=optional_float, default=0.6, help="<|nospeech|> probability above which (with failed logprob) a segment is considered silent")
    parser.add_argument("--word_timestamps", type=str2bool, default=False, help="extract word-level timestamps")
    parser.add_argument("--prepend_punctuations", type=str, default="\"'“¿([{-", help="with --word_timestamps: merge these punctuation symbols with the next word")
    parser.add_argument("--append_punctuations", type=str, default="\"'.。,，!！?？:：”)]}、", help="with --word_timestamps: merge these punctuation symbols with the previous word")
    parser.add_argument("--highlight_words", type=str2bool, default=False, help="(requires --word_timestamps) underline each word as it is spoken in srt/vtt")
    parser.add_argument("--max_line_width", type=optional_int, default=None, help="(requires --word_timestamps) max characters per subtitle line")
    parser.add_argument("--max_line_count", type=optional_int, default=None, help="(requires --word_timestamps) max lines per subtitle segment")
    parser.add_argument("--max_words_per_line", type=optional_int, default=None, help="(requires --word_timestamps, no effect with --max_line_width) max words per segment")
    parser.add_argument("--clip_timestamps", type=str, default="0", help="comma-separated start,end,... timestamps (s) of clips to process")
    parser.add_argument("--hallucination_silence_threshold", type=optional_float, help="(requires --word_timestamps) skip silent periods longer than this (s) when a possible hallucination is detected")
    parser.add_argument("--threads", type=optional_int, default=0, help="number of CPU threads for host-side compute (torch.set_num_threads)")
    # fmt: on
    return parser


def _checkpoint_path(parser: argparse.ArgumentParser, model_name: str, model_dir: Optional[str]) -> str:
    """A file, <model_dir>/<name>.pt, or an official checkpoint found where
    the JAX package keeps them; else the parser's error (an official name
    with the JAX package's "not found" message)."""
    from .models import available_models
    from .models.registry import _find_cached_checkpoint, default_download_root

    if os.path.isfile(model_name):
        return model_name
    path = os.path.join(model_dir, f"{model_name}.pt") if model_dir else None
    if path is not None and os.path.isfile(path):
        return path
    if model_name in available_models():
        found = _find_cached_checkpoint(model_name, default_download_root())
        if found is None:
            parser.error(f"Model {model_name} not found; available models = {available_models()}")
        return found
    parser.error(
        f"--model {model_name}: a checkpoint file is needed (a reference-layout .pt path, or "
        f"{model_name}.pt in --model_dir); nothing is downloaded"
    )


# sequential-only options that the independent windows of --batch_mode
# cannot honour, each with its reason
BATCH_DROPPED = {
    "verbose",  # per-segment streaming prints are sequential
    "condition_on_previous_text",  # windows decode independently
    "carry_initial_prompt",  # initial_prompt conditions every window already
}


def batch_supported() -> set:
    """The options `--batch_mode` routes: `transcribe_batch`'s parameters and
    the `DecodingOptions` fields, so that an option is either routed or
    refused, never dropped in silence."""
    from .decoding import DecodingOptions
    from .transcribe import transcribe_batch

    return (set(inspect.signature(transcribe_batch).parameters) | set(DecodingOptions.__dataclass_fields__)) - {
        "model", "audios", "batch_size", "mesh", "decode_options", "temperature"}


def cli(argv: Optional[List[str]] = None) -> None:
    import torch

    from .models import PRESET_DIMS, load_model
    from .models.registry import _ALIGNMENT_HEADS
    from .transcribe import transcribe, transcribe_batch

    parser = build_parser()
    args = parser.parse_args(argv).__dict__
    model_name: str = args.pop("model")
    model_dir: Optional[str] = args.pop("model_dir")
    output_dir: str = args.pop("output_dir")
    output_format: str = args.pop("output_format")
    device: str = args.pop("device")

    dp, tp = args.pop("dp"), args.pop("tp")
    mesh = None
    if args["batch_mode"] and (dp is not None or (tp or 1) > 1):
        from .parallel import create_mesh

        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
            torch.cuda.set_device(dev)
            device = str(dev)
        try:
            mesh = create_mesh((dp or 0, tp or 1), device=device)
        except ValueError as e:  # a shape the world's ranks do not fill
            parser.error(f"--dp {dp} --tp {tp}: {e}")
    writes = mesh is None or torch.distributed.get_rank() == 0
    os.makedirs(output_dir, exist_ok=True)

    if model_name.endswith(".en") and args["language"] not in {"en", "English"}:
        if args["language"] is not None:
            warnings.warn(f"{model_name} is an English-only model but received '{args['language']}'; using English instead.")
        args["language"] = "en"

    args["kv_quant"] = args.pop("kv_int8")
    temperature = args.pop("temperature")
    if (increment := args.pop("temperature_increment_on_fallback")) is not None:
        temperature = tuple(np.arange(temperature, 1.0 + 1e-6, increment))
    else:
        temperature = [temperature]

    if (threads := args.pop("threads") or 0) > 0:
        torch.set_num_threads(threads)

    checkpoint = _checkpoint_path(parser, model_name, model_dir)
    model = load_model(checkpoint, device=device)
    preset = PRESET_DIMS.get(model_name)
    if checkpoint != model_name and model_name in _ALIGNMENT_HEADS and (
        (preset.n_text_layer, preset.n_text_head) == (model.dims.n_text_layer, model.dims.n_text_head)
    ):  # a <name>.pt of other dims keeps the default heads
        model.set_alignment_heads(_ALIGNMENT_HEADS[model_name])

    writer = get_writer(output_format, output_dir)
    word_options = ["highlight_words", "max_line_count", "max_line_width", "max_words_per_line"]
    if not args["word_timestamps"]:
        for option in word_options:
            if args[option]:
                parser.error(f"--{option} requires --word_timestamps True")
    if args["max_line_count"] and not args["max_line_width"]:
        warnings.warn("--max_line_count has no effect without --max_line_width")
    if args["max_words_per_line"] and args["max_line_width"]:
        warnings.warn("--max_words_per_line has no effect with --max_line_width")
    writer_args = {arg: args.pop(arg) for arg in word_options}

    audio_paths = args.pop("audio")
    if args.pop("batch_mode"):
        if args.pop("hallucination_silence_threshold") is not None:
            parser.error("--hallucination_silence_threshold needs the sequential adaptive seek loop; "
                         "not supported with --batch_mode")
        supported = batch_supported()
        batch_args = {key: value for key, value in args.items() if key in supported}
        unroutable = [key for key in args if key not in supported and key not in BATCH_DROPPED]
        if unroutable:
            parser.error(f"option(s) {unroutable} are not routable to --batch_mode: add them to "
                         "transcribe_batch's signature or to the CLI's dropped table")
        try:
            results = transcribe_batch(model, list(audio_paths), mesh=mesh, temperature=tuple(temperature),
                                       **batch_args)
            for audio_path, result in zip(audio_paths, results):
                if writes:
                    writer(result, audio_path, **writer_args)
        except Exception as e:
            traceback.print_exc()
            print(f"Batch transcription failed: {type(e).__name__}: {str(e)}")
        return

    for audio_path in audio_paths:
        try:
            result = transcribe(model, audio_path, temperature=temperature, **args)
            writer(result, audio_path, **writer_args)
        except Exception as e:
            traceback.print_exc()
            print(f"Skipping {audio_path} due to {type(e).__name__}: {str(e)}")


if __name__ == "__main__":
    cli()
