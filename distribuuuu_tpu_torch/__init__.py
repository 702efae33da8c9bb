"""distribuuuu_tpu_torch: the PyTorch/CUDA port of distribuuuu_tpu for the H100.

The JAX package ``distribuuuu_tpu`` is the reference; this package mirrors
its layout module for module and imports nothing of it (nor of JAX). Its
kernels are hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, built at
first use (``ops/cuda/_build.py``). What is ported so far: serving and
training of the ResNet family, the RegNets, DenseNet-121/161/169/201,
BoTNet-50, EfficientNet-B0 and ViT-Ti/ViT-S, on dummy data, ImageFolder
trees or image shards, in one process or several (``torchrun``,
Slurm), with the JAX train loop's gradient accumulation, remat, verified
checkpoints, rollback, background commits, concurrent eval and fault
injection, and GPT-nano generation serving (``python -m
distribuuuu_tpu_torch.serve_net`` / ``train_net --cfg
config/<arch>.yaml``); on the card every serving bucket, LM tile, train
step (``TRAIN.STEPS_PER_CALL`` of them at once) and eval step replays one
CUDA graph (``graphs.py``); the JAX package's orbax checkpoints load with
no JAX (``utils/orbax.py``), serving quantizes weights (``SERVE.QUANTIZE``)
and runs as a fleet of replica processes (``serve_net --fleet N``); the
live plane referees it: serving campaigns against multi-model fleets
(``python -m distribuuuu_tpu_torch.serve_campaign``), the run monitor
(``python -m distribuuuu_tpu_torch.telemetry.live``) and the train+serve
soak (``python -m distribuuuu_tpu_torch.soak``); the mixture-of-experts
archs (``vit_tiny_moe``, ``gpt_nano_moe``) train and serve, and the
``MESH.MODEL`` and ``MESH.EXPERT`` axes run across processes (tensor- and
expert-parallel, ``parallel/``), and ZeRO stages 1 and 3 split the
optimizer state and the parameters over the data axis (``parallel/zero.py``),
with sharded background saves behind a cross-host commit barrier.
"""


def not_ported(what: str, item: str) -> NotImplementedError:
    """The refusal for a feature a later slice ports: names the
    ``ROADMAP.md`` Queue 1 item that holds it."""
    return NotImplementedError(
        f"{what} is not ported to distribuuuu_tpu_torch yet: see ROADMAP.md, "
        f'Queue 1, "{item}"'
    )
