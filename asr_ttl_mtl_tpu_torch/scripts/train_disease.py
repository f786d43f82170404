"""Train the multi-task (ASR + speech-disorder) model with the PyTorch port.

    python -m asr_ttl_mtl_tpu_torch.scripts.train_disease --model_size base \
        --pretrained random --train_csv train.csv --val_csv val.csv --save_dir out

Counterpart of `scripts/train_disease.py`, with the same flags. Training
runs on the card unless `--device cpu`. `--resume_dir` resumes from the
full training state written there after every epoch, and
`--audio_transfer_dtype mel_fp16` ships host-computed fp16 log-mels.
`--dp`, `--tp` and `--zero1` train over a mesh of ranks, one process per
rank as torchrun starts them (each on the card of its LOCAL_RANK; rank 0
writes the files):

    torchrun --nproc_per_node 2 -m asr_ttl_mtl_tpu_torch.scripts.train_disease \
        --dp 2 --zero1 --pretrained random --train_csv train.csv --val_csv val.csv --save_dir out

Flags asking for what the port does not serve (`--steps_per_call` > 1,
`--packed_dispatch True`) raise `NotImplementedError`. `--compute_dtype float32` trains in fp32, on the
card through its fp32 kernels. Writes
`best_multitask_model_<size>.pt`, `training_history_<size>.json` and
`training_config_<size>.json` into `--save_dir`.
"""

import argparse
import json
import os
import traceback
from dataclasses import asdict
from datetime import datetime

from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, MultiTaskTrainer, TrainingConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Multi-Task Speech Disorder Training (PyTorch port)")
    p.add_argument("--model_size", type=str, default="tiny",
                   choices=["tiny", "tiny.en", "base", "base.en", "small", "small.en",
                            "medium", "medium.en", "large", "turbo"])
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--val_batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--alpha", type=float, default=0.0,
                   help="classification loss weight; 0 = dynamic (one-shot)")
    p.add_argument("--beta", type=float, default=0.0,
                   help="transcription loss weight; 0 = dynamic (one-shot)")
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--gradient_clip_norm", type=float, default=1.0)
    p.add_argument("--early_stopping_patience", type=int, default=10)
    p.add_argument("--freeze_encoder", action="store_true")
    p.add_argument("--train_csv", type=str, default="../data/custom_train.csv")
    p.add_argument("--val_csv", type=str, default="../data/custom_val.csv")
    p.add_argument("--test_csv", type=str, default="../data/custom_test.csv")
    p.add_argument("--save_dir", type=str, default=".")
    p.add_argument("--pretrained", type=str, default=None,
                   help="local .pt checkpoint path, or 'random' (weights from --seed)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--audio_transfer_dtype", type=str, default="int16",
                   choices=["float32", "int16", "mel_fp16"],
                   help="audio host->device transfer: int16 waveforms (exact "
                        "for PCM), mel_fp16 host-computed log-mels (2x fewer "
                        "bytes), or float32 waveforms")
    p.add_argument("--dp", type=int, default=0, help="data-parallel mesh size (0 = all the ranks tp leaves)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh size")
    p.add_argument("--steps_per_call", type=int, default=0,
                   help="optimizer steps per call (the port: 0 or 1)")
    def strict_bool(v: str) -> bool:
        if v.lower() in ("true", "1", "yes"):
            return True
        if v.lower() in ("false", "0", "no"):
            return False
        raise argparse.ArgumentTypeError(f"expected True/False, got {v!r}")

    p.add_argument("--packed_dispatch", type=strict_bool,
                   default=None, metavar="True/False",
                   help="packed train state of the JAX package; not served by the port")
    def shard_map_mode(v: str):
        if v.lower() == "force":
            return "force"
        return strict_bool(v)

    p.add_argument("--dp_shard_map", type=shard_map_mode, default=True,
                   metavar="True/False/force",
                   help="the JAX package's choice of dp route (shard_map or "
                        "pjit); every value takes the port's one per-rank route, "
                        "and 'force' takes it on a mesh of one rank too")
    p.add_argument("--optimizer_moment_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of the AdamW moments; bfloat16 halves "
                        "their memory (the update math stays fp32)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: share the AdamW moments out over dp (dp > 1)")
    p.add_argument("--chunked_ce", type=str, default="auto",
                   metavar="auto/True/False",
                   help="chunked training cross-entropy: never materializes "
                        "the (B, T, vocab) logits (default auto: on)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume_dir", type=str, default=None,
                   help="directory of the full training state, written after every epoch "
                        "and resumed from when present (the port's own torch.save format)")
    p.add_argument("--debug_dims", type=str, default=None, metavar="JSON",
                   help="ModelDimensions overrides as a JSON dict (pairs with "
                        "--pretrained random; scaled-down smoke runs)")
    p.add_argument("--audio_samples", type=int, default=480000,
                   help="samples per training window (pairs with --debug_dims "
                        "whose n_audio_ctx = audio_samples / 320)")
    p.add_argument("--device", type=str, default="auto", choices=["auto", "cuda", "cpu"],
                   help="where to train: auto (the card) | cuda | cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.device != "cpu" and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        import torch

        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    config = TrainingConfig(
        model_size=args.model_size,
        device=args.device,
        epochs=args.epochs,
        batch_size=args.batch_size,
        val_batch_size=args.val_batch_size,
        learning_rate=args.learning_rate,
        alpha=args.alpha,
        beta=args.beta,
        weight_decay=args.weight_decay,
        gradient_clip_norm=args.gradient_clip_norm,
        early_stopping_patience=args.early_stopping_patience,
        freeze_encoder=args.freeze_encoder,
        train_csv=args.train_csv,
        val_csv=args.val_csv,
        test_csv=args.test_csv,
        save_dir=args.save_dir,
        pretrained=args.pretrained,
        compute_dtype=args.compute_dtype,
        num_workers=args.num_workers,
        audio_transfer_dtype=args.audio_transfer_dtype,
        mesh_shape=(args.dp, args.tp),
        steps_per_call=args.steps_per_call,
        packed_dispatch=args.packed_dispatch,
        dp_shard_map=args.dp_shard_map,
        optimizer_moment_dtype=args.optimizer_moment_dtype,
        zero1=args.zero1,
        chunked_ce=(args.chunked_ce if args.chunked_ce == "auto"
                    else args.chunked_ce.lower() in ("1", "true", "yes")),
        seed=args.seed,
        debug_dims=json.loads(args.debug_dims) if args.debug_dims else None,
        audio_samples=args.audio_samples,
    )

    os.makedirs(args.save_dir, exist_ok=True)
    try:
        train_ds = MultiTaskSpeechDataset(config.train_csv, config)
        val_ds = MultiTaskSpeechDataset(config.val_csv, config)
        print(f"train: {len(train_ds)} samples, val: {len(val_ds)} samples")

        train_loader = DataLoader(
            train_ds, config.batch_size, shuffle=True, num_workers=config.num_workers,
            drop_last=True, seed=config.seed, buckets=config.token_buckets,
        )
        val_loader = DataLoader(
            val_ds, config.val_batch_size, shuffle=False,
            num_workers=config.num_workers, buckets=config.token_buckets,
        )

        trainer = MultiTaskTrainer(config)
        result = trainer.train(train_loader, val_loader, resume_dir=args.resume_dir)

        if not trainer.writes:
            return
        config_path = os.path.join(args.save_dir, f"training_config_{args.model_size}.json")
        with open(config_path, "w") as f:
            json.dump(
                {
                    "config": asdict(config),
                    "best_loss": result["best_loss"],
                    "final_alpha": trainer.alpha,
                    "final_beta": trainer.beta,
                    "timestamp": datetime.now().isoformat(),
                },
                f,
                indent=2,
            )
        print(f"Training config saved: {config_path}")
        print(f"Best validation loss: {result['best_loss']:.4f}")
    except KeyboardInterrupt:
        print("Training interrupted by user")
    except Exception:
        debug_path = os.path.join(args.save_dir, "debug_info.txt")
        with open(debug_path, "w") as f:
            f.write(traceback.format_exc())
        print(f"Training crashed; traceback written to {debug_path}")
        raise


if __name__ == "__main__":
    main()
