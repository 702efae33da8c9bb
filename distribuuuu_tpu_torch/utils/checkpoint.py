"""Checkpoints and auto-resume (counterpart of distribuuuu_tpu/utils/checkpoint.py).

One ``torch.save`` payload per save under ``{OUT_DIR}/checkpoints``, by the
JAX package's names: ``ckpt_ep_NNN.pth`` after epoch NNN (the parameters
and BN buffers, the optimizer state, the step, the epoch and ``best_acc1``),
a weights-only ``best.pth`` on a new best, and ``preempt_ep_NNN.pth``
written mid-epoch on preemption. ``preempt_ep_e`` holds newer progress than
``ckpt_ep_{e-1}`` and is superseded by ``ckpt_ep_e``.

Crash consistency (``resilience/manifest.py``): a save writes the payload
to a temporary file and renames it, then commits its manifest sidecar
``<name>.pth.manifest.json`` strictly last. A file without its manifest
never committed. :func:`find_last_valid_checkpoint`, the resume's entry,
verifies candidates newest first, quarantines a corrupt or uncommitted
one to ``<name>.pth.corrupt[.N]`` and walks back to the newest intact
save; :class:`NoValidCheckpointError` when none survives.

``CHECKPOINT.ASYNC`` (``asyncplane/committer.py``): the trainer blocks for
the host snapshot only; the write, fsync, rename and manifest run on the
committer thread, in the same order. With several processes the commit
goes through the cross-host commit barrier (``committer.multihost_
commit``): the manifest is written strictly last, once every process has
arrived. Preemption saves are synchronous and join the committer first;
under the shards format they also hold the loader's exact cursor
(``data_state``, a uint8 tensor of its JSON).

A ZeRO run whose state is split across the processes (``MESH.ZERO`` 1 or
3 at two or more data ranks) saves in the background by the sharded
protocol (:func:`save_sharded_checkpoint`, JAX's ``_save_sharded``): a
directory ``ckpt_ep_NNN/`` in the JAX package's layout, each process
writing the blocks it owns as ``shards_host<r>.npz`` + ``SHARDS_host<r>.
json`` and the primary ``MANIFEST.json`` last, behind the barrier. Its
``params`` and ``batch_stats`` are under the JAX package's paths and
layouts (``utils/weights.jax_tree_from_state_dict``), so the JAX
package's ``committer.read_sharded_checkpoint`` and the port's
``MODEL.WEIGHTS`` reader both read it; the optimizer's moments, its
count and learning rate, the step, epoch and best Acc@1, and the BN
counters JAX does not keep are under the port's own names. The
weights-only ``best`` of such a save is written up front, synchronously.
A synchronous save is one full-tensor ``.pth`` whatever the stage.

With several processes only the primary writes a full-tensor save and
quarantines; every process loads. A synchronous save ends at a barrier;
the walk-back runs on the primary after it joins the committer, and every
process takes the path it broadcasts. The payload is the same as with one
process (the model's ``state_dict`` keys unchanged), so a checkpoint of
either resumes the other: under a model or expert axis the trainer
gathers the shards into full tensors before the save and slices them at
the load (``parallel/partition/specs.full_train_state``,
``load_full_model``); a sharded save is put back together into the same
full tensors (:func:`load_checkpoint`).

Telemetry, on the ``ckpt`` track of the primary's sink: a synchronous
save is one ``ckpt_save`` span; a background one a ``ckpt_snapshot`` span
(what the trainer blocked for), a ``ckpt_commit`` span on the committer
thread and one ``ckpt.async`` record; a load is a ``ckpt_restore`` span.
"""

from __future__ import annotations

import json
import os
import re
import time

import numpy as np
import torch

from distribuuuu_tpu_torch.asyncplane import committer
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.parallel import dist
from distribuuuu_tpu_torch.resilience import manifest
from distribuuuu_tpu_torch.telemetry import spans as telemetry_spans
from distribuuuu_tpu_torch.utils import faults
from distribuuuu_tpu_torch.utils.logger import get_logger

_NAME_PREFIX = "ckpt_ep_"
_PREEMPT_PREFIX = "preempt_ep_"
_BEST_NAME = "best"
_EXT = ".pth"


class CheckpointError(RuntimeError):
    """A checkpoint could not be read."""


class NoValidCheckpointError(CheckpointError, FileNotFoundError):
    """Checkpoints exist (or none do) but none verifies intact."""


def get_checkpoint_dir() -> str:
    return os.path.abspath(os.path.join(cfg.OUT_DIR, "checkpoints"))


def get_checkpoint(epoch: int) -> str:
    return os.path.join(get_checkpoint_dir(), f"{_NAME_PREFIX}{epoch:03d}{_EXT}")


def get_preempt_checkpoint(epoch: int) -> str:
    return os.path.join(get_checkpoint_dir(), f"{_PREEMPT_PREFIX}{epoch:03d}{_EXT}")


def get_best_checkpoint() -> str:
    return os.path.join(get_checkpoint_dir(), _BEST_NAME + _EXT)


def get_sharded_checkpoint(epoch: int) -> str:
    """The sharded save directory of epoch ``epoch``."""
    return os.path.join(get_checkpoint_dir(), f"{_NAME_PREFIX}{epoch:03d}")


def _scan(prefix: str) -> dict[int, str]:
    """``{epoch: path}`` of the saves named ``prefix`` + NNN: ``.pth`` files
    and sharded directories alike."""
    d = get_checkpoint_dir()
    if not os.path.isdir(d):
        return {}
    pat = re.compile(re.escape(prefix) + r"(\d+)(?:" + re.escape(_EXT) + ")?")
    return {int(m.group(1)): os.path.join(d, f)
            for f in os.listdir(d) if (m := pat.fullmatch(f))}


def _ordered_candidates() -> list[str]:
    """Every resumable checkpoint, newest state first: ``preempt_ep_e``
    ranks between ``ckpt_ep_{e-1}`` and ``ckpt_ep_e``."""
    ranked = [(2 * e + 2, p) for e, p in _scan(_NAME_PREFIX).items()]
    ranked += [(2 * e + 1, p) for e, p in _scan(_PREEMPT_PREFIX).items()]
    return [p for _, p in sorted(ranked, reverse=True)]


def get_last_checkpoint() -> str:
    """The newest checkpoint by that ranking, unverified."""
    cands = _ordered_candidates()
    if not cands:
        raise FileNotFoundError(f"No checkpoints in {get_checkpoint_dir()}")
    return cands[0]


def has_checkpoint() -> bool:
    return bool(_scan(_NAME_PREFIX) or _scan(_PREEMPT_PREFIX))


def quarantine_checkpoint(path: str, reason: str) -> str | None:
    """Move a broken checkpoint (and its manifest, if any) aside as
    ``<name>.corrupt[.N]``, on the primary. Returns the new path."""
    logger = get_logger()
    if not dist.is_primary():
        logger.warning("checkpoint %s failed verification (%s): skipping (the primary "
                       "quarantines)", path, reason)
        return None
    dest, n = path + ".corrupt", 0
    while os.path.exists(dest):
        n += 1
        dest = f"{path}.corrupt.{n}"
    try:
        os.replace(path, dest)
        if os.path.exists(manifest.manifest_path(path)):
            os.replace(manifest.manifest_path(path), manifest.manifest_path(dest))
    except OSError as e:
        logger.warning("could not quarantine %s (%s); skipping it", path, e)
        return None
    logger.warning("quarantined corrupt checkpoint %s -> %s (%s)", path, dest, reason)
    return dest


def _walk_back() -> tuple[str | None, str | None]:
    cands = _ordered_candidates()
    if not cands:
        return None, f"No checkpoints in {get_checkpoint_dir()}"
    for i, path in enumerate(cands):
        ok, reason = manifest.verify_checkpoint(path)
        if ok:
            if i:
                get_logger().warning("walked back over %d broken checkpoint(s) to %s", i, path)
            return path, None
        quarantine_checkpoint(path, reason)
    return None, (f"{len(cands)} checkpoint(s) under {get_checkpoint_dir()} but none "
                  "verified intact (all quarantined to *.corrupt); inspect the quarantined "
                  "files or restart training from scratch")


def find_last_valid_checkpoint() -> str:
    """The newest checkpoint that verifies, walking back over (and
    quarantining) corrupt or uncommitted ones; raises
    :class:`NoValidCheckpointError` when none survives. Joins the
    in-flight commit first; with several processes the primary walks and
    every process takes its answer."""
    committer.join_commits()
    path, err = _walk_back() if dist.is_primary() else (None, None)
    path, err = dist.broadcast_from_primary((path, err))
    if err is not None:
        raise NoValidCheckpointError(err)
    return path


def _cpu(tree):
    """A host copy of ``tree`` that later steps cannot touch (a CPU
    tensor is copied, not aliased)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def _write_payload(path: str, payload: dict, kind: str, epoch: int | None,
                   durable: bool = False) -> None:
    """Payload to a temporary file, renamed into place. ``durable`` (the
    committer) fsyncs it before the rename, so the manifest's order holds
    through a power loss too."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    if durable:
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if kind == "full":
        # the crash window, injectable: the payload is in place, its
        # manifest is not (no-op unless FAULTS.*)
        faults.maybe_kill_mid_async_save(path, epoch if epoch is not None else -1)


def _write(path: str, payload: dict, kind: str, epoch: int | None,
           durable: bool = False) -> str:
    """The payload (:func:`_write_payload`), then the manifest strictly
    last."""
    _write_payload(path, payload, kind, epoch, durable)
    manifest.write_manifest(path, payload, kind=kind, epoch=epoch,
                            world=dist.get_world_size())
    return path


def _commit(label: str, fn) -> None:
    """``fn`` on the committer under ``CHECKPOINT.ASYNC``, else now."""
    if cfg.CHECKPOINT.ASYNC:
        committer.submit_commit(label, lambda: fn(True))
    else:
        fn(False)


def prune_preempts(upto: int) -> None:
    """Delete preempt checkpoints numbered ``<= upto`` (superseded), and
    their manifests, on the primary."""
    if not dist.is_primary():
        return
    for e, p in _scan(_PREEMPT_PREFIX).items():
        if e <= upto:
            os.remove(p)
            if os.path.exists(manifest.manifest_path(p)):
                os.remove(manifest.manifest_path(p))


def _best_payload(model_sd: dict, epoch: int) -> dict:
    return {"model": model_sd, "epoch": epoch}


def save_checkpoint(state: dict, epoch: int, best_acc1: float, is_best: bool) -> str:
    """Save the full state after ``epoch`` (``state``: ``model``, ``opt``,
    ``step``); side-write the weights-only ``best`` on a new best. After the
    commit: the best side-write, the preempt pruning and the corrupt-
    checkpoint fault hook. The primary writes (on the committer under
    ``CHECKPOINT.ASYNC``); a synchronous save ends at a barrier."""
    path = get_checkpoint(epoch)
    world = dist.get_world_size()
    name = os.path.basename(path)
    tags = {"track": "ckpt", "ckpt": name, "epoch": int(epoch)}
    if cfg.CHECKPOINT.ASYNC and world > 1 and not dist.is_primary():
        # a peer of the cross-host barrier: nothing of its own to write
        committer.submit_commit(name, lambda: committer.multihost_commit(
            path, epoch, None, manifest.manifest_path(path), dist.get_rank(), world))
    if dist.is_primary():

        def post(durable, payload):
            if is_best:
                _write(get_best_checkpoint(), _best_payload(payload["model"], epoch),
                       "weights", epoch, durable)
            prune_preempts(epoch)
            faults.maybe_corrupt_checkpoint(path, epoch)

        def commit(durable, payload):
            if world > 1 and durable:  # behind the barrier, the manifest last
                committer.multihost_commit(
                    path, epoch,
                    lambda: manifest.write_manifest(path, payload, kind="full", epoch=epoch,
                                                    world=world),
                    manifest.manifest_path(path), 0, world,
                    write_payload=lambda: _write_payload(path, payload, "full", epoch, True),
                    post_commit=lambda: post(durable, payload))
                return
            _write(path, payload, "full", epoch, durable)
            post(durable, payload)

        if cfg.CHECKPOINT.ASYNC:
            t0 = time.perf_counter()
            with telemetry_spans.span("ckpt_snapshot", **tags):
                payload = {**_cpu(state), "epoch": epoch, "best_acc1": float(best_acc1)}
            snapshot_s = time.perf_counter() - t0

            def background():
                c0 = time.perf_counter()
                with telemetry_spans.span("ckpt_commit", **tags):
                    commit(True, payload)
                committer.emit_commit_record(name, snapshot_s, time.perf_counter() - c0)

            committer.submit_commit(name, background)
        else:
            with telemetry_spans.span("ckpt_save", **tags):
                commit(False, {**_cpu(state), "epoch": epoch, "best_acc1": float(best_acc1)})
    if not cfg.CHECKPOINT.ASYNC:
        dist.barrier()
    return path


def save_best_checkpoint(model_sd: dict, epoch: int) -> str:
    """The weights-only ``best`` side-write alone, for the concurrent-eval
    join (the epoch checkpoint was committed at the boundary, the verdict
    arrives one epoch later); ``model_sd`` is the eval snapshot's."""
    path = get_best_checkpoint()
    if dist.is_primary():
        payload = _best_payload(_cpu(model_sd), epoch)
        _commit(os.path.basename(path),
                lambda durable: _write(path, payload, "weights", epoch, durable))
    if not cfg.CHECKPOINT.ASYNC:
        dist.barrier()
    return path


def encode_data_state(data_state: dict) -> torch.Tensor:
    """The loader's state (``data/loader.Loader.state_dict``: JSON-able,
    with the shuffle generator's big ints) as a uint8 tensor of its JSON,
    as the JAX package stores it as a uint8 array: the payload stays
    loadable under ``torch.load(weights_only=True)``."""
    raw = json.dumps(data_state, sort_keys=True).encode()
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).clone()


def decode_data_state(arr) -> dict | None:
    """Inverse of :func:`encode_data_state` (a tensor or a uint8 array);
    None when unreadable: a damaged cursor costs the mid-epoch exactness,
    never the resume."""
    raw = arr.numpy() if torch.is_tensor(arr) else arr
    try:
        return json.loads(np.asarray(raw, np.uint8).tobytes().decode())
    except (ValueError, UnicodeDecodeError):
        return None


def save_preempt_checkpoint(state: dict, epoch: int, best_acc1: float,
                            pending_eval: int | None = None,
                            data_state: dict | None = None) -> str:
    """Mid-epoch save on preemption. ``epoch`` is the interrupted one; the
    stored cursor is ``epoch - 1`` so the resume re-runs that epoch from
    this newer state. ``pending_eval`` marks a finished epoch whose
    validation was preempted: the resume validates it first.
    ``data_state`` (the shards format's ``Loader.state_dict``) is the
    exact global sample cursor: the resumed epoch continues at the next
    batch instead of batch 0. Always synchronous, after joining the
    committer; the primary writes, behind a barrier."""
    committer.join_commits(reason="preemption")
    path = get_preempt_checkpoint(epoch)
    if dist.is_primary():
        payload = {**_cpu(state), "epoch": epoch - 1, "best_acc1": float(best_acc1)}
        if pending_eval is not None:
            payload["pending_eval"] = int(pending_eval)
        if data_state is not None:
            payload["data_state"] = encode_data_state(data_state)
        with telemetry_spans.span("ckpt_save", track="ckpt", ckpt=os.path.basename(path),
                                  epoch=int(epoch - 1)):
            _write(path, payload, "full", epoch - 1)
    dist.barrier()
    return path


def load_checkpoint(path: str) -> dict:
    """The payload at ``path`` (tensors on the CPU; a sharded directory put
    back together into the same full-tensor payload); raises
    :class:`CheckpointError` naming the path when it cannot be read."""
    try:
        with telemetry_spans.span("ckpt_restore", track="ckpt", ckpt=os.path.basename(path)):
            if manifest.is_dir_checkpoint(path):
                return _payload_from_tree(committer.read_sharded_checkpoint(path))
            return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # torch.load raises many concrete types
        raise CheckpointError(
            f"failed to load checkpoint {path} ({type(e).__name__}: {e}); move it "
            "aside to resume from the previous one, or start a fresh OUT_DIR"
        ) from e


# ---------------------------------------------------------------- sharded saves

_LAYOUT_DTYPE = {torch.float32: "float32", torch.float64: "float64",
                 torch.bfloat16: "bfloat16", torch.int64: "int64"}


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` the next steps cannot touch (bfloat16 as its
    raw 16-bit words)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def sharded_protocol(model) -> bool:
    """Whether a background save of ``model``'s run takes the sharded
    protocol: several processes and a ZeRO runtime that splits leaves
    over data."""
    return bool(cfg.CHECKPOINT.ASYNC) and dist.get_world_size() > 1 and \
        getattr(model, "zero_runtime", None) is not None


def _owner(mesh, split_axes) -> bool:
    """This rank owns its blocks of a leaf split over ``split_axes``: its
    coordinate is 0 on every other populated axis."""
    return all(mesh.index(a) == 0 for a, n in mesh.sizes.items()
               if n > 1 and a not in split_axes)


def _block(shape, tp, zdim, rt):
    """The ``[start, stop]`` ranges (port dims) of this rank's block of a
    leaf of full ``shape``: its model/expert slice (``tp``), then its data
    shard of that (``zdim``)."""
    rng = [[0, int(d)] for d in shape]
    if tp is not None:
        k = shape[tp.dim] // tp.size
        rng[tp.dim] = [tp.index * k, (tp.index + 1) * k]
    if zdim is not None:
        a, b = rng[zdim]
        k = (b - a) // rt.n
        rng[zdim] = [a + rt.r * k, a + (rt.r + 1) * k]
    return rng


def sharded_tree(model, optimizer, step: int, epoch: int, best_acc1: float) -> dict:
    """This process's view of the sharded save's tree: each parameter and
    moment a ``committer.Blocks`` of the blocks it owns (the JAX layout
    under JAX's paths for parameters, the port's layout under its names
    for moments), the BN statistics and counters and the scalars as host
    values (written by rank 0)."""
    from distribuuuu_tpu_torch.parallel import mesh as mesh_lib
    from distribuuuu_tpu_torch.parallel import zero
    from distribuuuu_tpu_torch.utils import weights

    mesh, rt = mesh_lib.current(), model.zero_runtime
    shards = getattr(model, "shards", {})
    sd = model.state_dict()
    paths = weights.port_path_map(sd)
    tree: dict = {}

    def put(path, leaf):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    moments = {"m": optimizer.m, "v": optimizer.v}
    for i, name in enumerate(optimizer.names):
        p, tp, zdim = optimizer.params[i], shards.get(name), rt.zdims[i]
        full = list(p.shape)
        if tp is not None:
            full[tp.dim] *= tp.size
        rng = _block(full, tp, zdim, rt)
        split = ({"data"} if zdim is not None else set()) | \
            ({a for a, g in mesh.groups.items() if tp is not None and g is tp.group})
        own = _owner(mesh, split)
        if zdim is None:
            data = p
        elif rt.resting:
            data = rt.pshard[i]
        else:
            data = zero.shard_of(p, zdim, rt.n, rt.r)
        dtype = _LAYOUT_DTYPE[p.dtype]
        put(paths[name], committer.Blocks(
            zero.to_jax(name, tuple(full)), dtype,
            [(zero.to_jax(name, tuple(rng)), weights.jax_layout(_host(data), name))]
            if own else []))
        for key, bufs in moments.items():
            if bufs is None:
                continue
            put(("opt", key, name), committer.Blocks(
                tuple(full), _LAYOUT_DTYPE[bufs[i].dtype],
                [(tuple(rng), _host(bufs[i]))] if own else []))
    params = {n for n, _ in model.named_parameters()}
    for key, t in sd.items():
        if key in params:
            continue
        if key in paths:
            put(paths[key], weights.jax_layout(_host(t), key))
        else:  # what JAX does not keep (BN counters)
            put(("model_extra", key), _host(t))
    put(("opt", "count"), np.int64(optimizer.count))
    put(("opt", "lr"), np.float64(optimizer.lr))
    put(("step",), np.int64(step))
    put(("epoch",), np.int64(epoch))
    put(("best_acc1",), np.float64(best_acc1))
    return tree


def _payload_from_tree(tree: dict) -> dict:
    """A sharded save's tree (full numpy arrays) as the port's payload: the
    model's state dict (``utils/weights.state_dict_from_jax``, each leaf's
    dtype kept, plus the counters), the optimizer state and the scalars."""
    from distribuuuu_tpu_torch.utils import weights

    sd = weights.state_dict_from_jax(tree["params"], tree.get("batch_stats"), keep_dtype=True)
    for key, arr in tree.get("model_extra", {}).items():
        sd[key] = torch.from_numpy(np.array(arr))
    opt = tree.get("opt", {})
    out = {"model": sd, "step": int(tree.get("step", 0)), "epoch": int(tree["epoch"]),
           "best_acc1": float(tree.get("best_acc1", 0.0))}
    if opt:
        out["opt"] = {"count": int(opt["count"]), "lr": float(opt["lr"]),
                      **{k: None if k not in opt else
                         {n: torch.from_numpy(np.array(a)) for n, a in opt[k].items()}
                         for k in ("m", "v")}}
    return out


def save_sharded_checkpoint(model, optimizer, step: int, epoch: int, best_acc1: float,
                            is_best: bool, best_state=None) -> str:
    """The sharded background save of epoch ``epoch`` (every process calls
    it, JAX's ``_save_sharded``). On-path: the best side-write up front
    (``best_state()``: the full model state dict, a collective; the
    primary writes ``best.pth`` synchronously), then this process's
    snapshot of the blocks it owns and the tree spec. Off-path, on the
    committer: each process writes its ``shards_host<r>.npz`` and layout
    and arrives at the barrier; the primary commits ``MANIFEST.json``
    last, whose digest walk covers every process's files, then prunes the
    preemption saves. Bounded by ``ASYNC.BARRIER_TIMEOUT_S``; a failure
    surfaces as ``AsyncCommitError`` at the next join."""
    path = get_sharded_checkpoint(epoch)
    name = os.path.basename(path)
    rank, world = dist.get_rank(), dist.get_world_size()
    committer.join_commits()
    if is_best:
        sd = best_state()
        if dist.is_primary():
            _write(get_best_checkpoint(), _best_payload(_cpu(sd), epoch), "weights", epoch)
        dist.barrier()
    t0 = time.perf_counter()
    with telemetry_spans.span("ckpt_snapshot", track="ckpt", ckpt=name, epoch=int(epoch)):
        owned, layout = committer.snapshot_host_shards(
            sharded_tree(model, optimizer, step, epoch, best_acc1), rank)
        tree = {"/".join(leaf["path"]): {"shape": leaf["shape"], "dtype": leaf["dtype"]}
                for leaf in layout["leaves"]}
    snapshot_s = time.perf_counter() - t0
    record = {"hosts": world, "files": [committer.shards_name(r) for r in range(world)]}

    def write_mine():
        w0 = time.perf_counter()
        nbytes = committer.write_host_shards(path, rank, world, owned, layout)
        committer.emit_shard_record(name, rank, world, len(owned), nbytes,
                                    time.perf_counter() - w0)

    def post():
        faults.maybe_drop_shard_file(path, epoch, world)
        prune_preempts(epoch)

    def background():
        c0 = time.perf_counter()
        with telemetry_spans.span("ckpt_commit", track="ckpt", ckpt=name, epoch=int(epoch)):
            committer.multihost_commit(
                path, epoch,
                lambda: manifest.write_dir_manifest(path, tree, "full", epoch, world, record),
                manifest.manifest_path(path), rank, world, write_payload=write_mine,
                write_local=write_mine, post_commit=post, sharded=True)
        committer.emit_commit_record(name, snapshot_s, time.perf_counter() - c0)

    committer.submit_commit(name, background)
    return path
