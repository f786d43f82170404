"""What each rank runs in the multi-device tests (tests/test_torch_parallel*.py).

`parallel.launch.run_ranks` spawns the ranks, which import this module by
name: it imports torch and the port, never JAX, so a rank starts in a few
seconds. Every function takes its rank and a payload of plain data (numpy
arrays, state dicts of CPU tensors, paths), runs the port's entry points
over the process group that `run_ranks` made (gloo, 2 ranks), and returns
what the test compares with the JAX package: tokens, log-probs, losses,
gradient norms, weights.
"""

import os

import numpy as np
import torch

torch.set_num_threads(1)  # as tests/torch_port_helpers.py: one thread a process


def _model(state: dict, dims: dict):
    from asr_ttl_mtl_tpu_torch.models import ModelDimensions, WhisperModel

    model = WhisperModel(ModelDimensions(**dims), compute_dtype=torch.float32)
    model.load_state_dict(state)
    return model.eval().requires_grad_(False)


def _summary(results):
    return [(r.tokens, r.avg_logprob, r.no_speech_prob, r.text) for r in results]


def serve_cases(rank: int, payload: dict) -> dict:
    """The serving cases: `decode_batched_dp` at each mesh and options,
    sampled rungs against this process's single-device port, the mesh
    refusals, `transcribe_batch` over a mesh and the CLI's --dp / --tp."""
    from asr_ttl_mtl_tpu_torch import cli as PC
    from asr_ttl_mtl_tpu_torch import transcribe as PT
    from asr_ttl_mtl_tpu_torch.decoding import DecodingOptions, DecodingTask
    from asr_ttl_mtl_tpu_torch.parallel import create_mesh, shard_batch, shard_params
    from asr_ttl_mtl_tpu_torch.parallel.serving import decode_batched_dp

    out = {}
    meshes = {shape: create_mesh(shape, device="cpu") for shape in ((2, 1), (1, 2))}
    model = _model(payload["state"], payload["dims"])
    mel = torch.from_numpy(payload["mel"])
    for name, shape, opts in payload["decode_cases"]:
        out[name] = _summary(decode_batched_dp(model, mel, DecodingOptions(**opts), mesh=meshes[shape]))

    # sampled rungs: the noise of the whole batch, each rank its rows
    sampled = DecodingOptions(**payload["sampled"])
    out["sampled"] = _summary(decode_batched_dp(model, mel, sampled, mesh=meshes[(2, 1)], rng_seed=3))
    out["sampled_single"] = _summary(DecodingTask(model, sampled).run(mel, rng_seed=3))

    # the shard: local widths, the tags, the cache on the model
    shard = shard_params(model, meshes[(1, 2)])
    out["shard"] = {name: tuple(p.shape) for name, p in shard.named_parameters()}
    out["shard_cached"] = shard_params(model, meshes[(1, 2)]) is shard
    out["shard_batch"] = shard_batch({"audio": np.arange(12).reshape(6, 2), "n": 6}, meshes[(2, 1)])

    refusals = {}
    for shape in ((4, 1), (3, 1), (0, 3)):
        try:
            create_mesh(shape, device="cpu")
            refusals[str(shape)] = None
        except ValueError as e:
            refusals[str(shape)] = str(e)
    out["refusals"] = refusals

    batch_model = _model(payload["batch_state"], payload["batch_dims"])
    for name, shape, kw in payload["batch_cases"]:
        out[name] = PT.transcribe_batch(batch_model, list(payload["audios"]), mesh=meshes[shape], **kw)

    for name, argv in payload["cli_cases"]:
        out_dir = os.path.join(payload["cli_root"], f"{name}_rank{rank}")
        PC.cli(list(argv) + ["--output_dir", out_dir])
        out[name] = sorted(os.listdir(out_dir))
    return out


def train_cases(rank: int, payload: dict) -> dict:
    """The training cases: per case (a mesh and its settings), train steps
    from the carried weights on the given batches and keep-masks, then
    `evaluate`; and, given `resume`, an epoch of `train` that writes its
    resume state at this world size."""
    from asr_ttl_mtl_tpu_torch.mtl import MultiTaskTrainer, TrainingConfig
    from asr_ttl_mtl_tpu_torch.mtl.fused_optim import group_of

    out = {}
    for case in payload["cases"]:
        cfg = TrainingConfig(**payload["config"], **case["kw"], device="cpu",
                             save_dir=os.path.join(payload["root"], case["name"]))
        trainer = MultiTaskTrainer(cfg, verbose=False)
        trainer.load_state(payload["model_state"], payload["classifier_state"])
        steps = []
        for batch, keep in zip(case["batches"], case["keeps"]):
            loss, aux = trainer.train_step(batch, keep=torch.from_numpy(keep))
            norms = {}
            for name, p in trainer.named_trainable():
                g = trainer._tp_whole(name, p.grad)
                norms[group_of(name)] = norms.get(group_of(name), 0.0) + float(g.double().square().sum())
            steps.append(dict(loss=float(loss), cls_loss=float(aux["cls_loss"]),
                              trans_loss=float(aux["trans_loss"]), alpha=trainer.alpha, beta=trainer.beta,
                              norms={k: float(np.sqrt(v)) for k, v in norms.items()},
                              pred_tokens=aux["pred_tokens"].numpy(), disease_preds=aux["disease_preds"].numpy()))
        metrics = trainer.evaluate(case["val"]) if case.get("val") else None
        model_state = {k: v.numpy() for k, v in trainer.full_model_state().items()}
        classifier = {k: v.detach().numpy() for k, v in trainer.classifier.state_dict().items()}
        opt = trainer.full_optimizer_state()
        out[case["name"]] = dict(steps=steps, metrics=metrics, model=model_state, classifier=classifier,
                                 opt_count=opt["count"], opt_m={g: [x.numpy() for x in xs] for g, xs in opt["m"].items()},
                                 mesh=dict(zip(("dp", "tp"), trainer.mesh.shape)), zero1=trainer.optimizer.zero1)
    resume = payload.get("resume")
    if resume:
        cfg = TrainingConfig(**payload["config"], **resume["kw"], device="cpu",
                             save_dir=os.path.join(payload["root"], "resume_run"))
        trainer = MultiTaskTrainer(cfg, verbose=False)
        trainer.load_state(payload["model_state"], payload["classifier_state"])
        out["resume"] = trainer.train(resume["train"], resume["val"], resume_dir=resume["dir"])
    script = payload.get("script")
    if script:  # the training twin's entry point, each rank with its own save_dir
        from asr_ttl_mtl_tpu_torch.scripts import train_disease

        save_dir = os.path.join(payload["root"], f"script_rank{rank}")
        train_disease.main(list(script) + ["--save_dir", save_dir])
        out["script"] = sorted(os.listdir(save_dir))
    return out
