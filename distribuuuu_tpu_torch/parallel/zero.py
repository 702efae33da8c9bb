"""ZeRO stages 1 and 3 over the ``data`` axis (counterpart of
distribuuuu_tpu/parallel/zero.py and the ZeRO arms of
distribuuuu_tpu/parallel/partition/lowering.py).

The JAX package declares the layout and GSPMD derives the collectives.
Here the same layout is computed leaf for leaf and the collectives are
issued by hand:

* the spec algebra, :func:`add_data_axis` and :func:`strip_data_axis`,
  on spec tuples (one entry a dim: None, an axis name or a tuple of
  names). A leaf's ZeRO spec is computed on its JAX layout (the shape and
  base spec the JAX package sees: a conv ``[kh, kw, I, O]``, a Dense
  kernel ``[in, out]``) and the chosen dim is mapped back through the
  transpose (``utils/weights.jax_perm``), so a port leaf's shard holds the same
  elements as JAX's shard of the same leaf;
* :func:`plan_model`: every parameter's ZeRO dim on this rank's
  (possibly model- or expert-placed) tensor. A ``('model', 'data')``
  entry splits the dim model-major, as GSPMD orders a tuple of axes: the
  rank's model shard, split again over the data group;
* :class:`ZeroRuntime`: the optimizer's shard buffers and the step's
  collectives. Gradients are reduce-scattered from the step's own
  gradients into each rank's shards (packed ``[N, shard]`` rows, one
  collective a bucket, into kept bucket outputs that are the shards; the
  leaves with no qualifying dim are all-reduced whole in the optimizer's
  full buffers), the fused update runs on the shards, and stage 1
  all-gathers the updated shards back into the replicated parameters
  (a dim-0 shard of a contiguous parameter is updated in place, the
  others in a staged copy). At stage 3 the parameters rest as shards
  (:attr:`ZeroRuntime.pshard`; the full tensors' storage is freed) and
  are gathered for the step: once at step entry for the leaves
  ``ZERO.GATHER_AHEAD`` hoists (every one at -1), at each use for the
  rest (a forward pre-hook, freed after the module's forward, gathered
  again where the backward reads them: ``saved_tensors_hooks``).

The update is elementwise per leaf, so a shard's update is the whole
leaf's restricted to it, and a sum of two ranks' gradients is the same
number in either order: at two data ranks every stage and every schedule
gives the stage-0 bits.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field

import torch

DATA_AXIS = "data"

# leaves smaller than this stay replicated (the JAX package's constant):
# sharding a 64-float bias saves nothing and costs a collective
MIN_SHARD_ELEMS = 8192

# ---------------------------------------------------------------- spec algebra


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def strip_data_axis(spec) -> tuple:
    """``spec`` with ``data`` taken out of every entry: the layout a ZeRO
    leaf has during compute, once gathered (the inverse of
    :func:`add_data_axis`)."""
    out = []
    for entry in spec or ():
        names = tuple(n for n in _names(entry) if n != DATA_AXIS)
        out.append(None if not names else names[0] if len(names) == 1 else names)
    return tuple(out)


def add_data_axis(spec, shape, data_size: int, axis_sizes: dict | None = None) -> tuple:
    """``spec`` with ``data`` added on the best divisible dim, as the JAX
    package chooses it: a dim qualifies when its remaining extent (its
    size over the extent of the axes already splitting it) divides by
    ``data_size``; the largest remaining extent wins, a free dim wins a
    tie against a split one, else the lower dim. On a split dim ``data``
    is appended to its tuple. A leaf under :data:`MIN_SHARD_ELEMS`
    elements, or with no qualifying dim, keeps ``spec``."""
    base = tuple(spec or ())
    axis_sizes = axis_sizes or {}
    size = 1
    for d in shape:
        size *= int(d)
    if data_size <= 1 or size < MIN_SHARD_ELEMS:
        return base
    entries = base + (None,) * (len(shape) - len(base))
    best, best_ext, best_free = -1, 0, False
    for i, (e, d) in enumerate(zip(entries, shape)):
        names = _names(e)
        if DATA_AXIS in names:
            return base
        taken = 1
        for n in names:
            taken *= axis_sizes.get(n, 1)
        if int(d) % (taken * data_size):
            continue
        ext, free = int(d) // taken, not names
        if ext > best_ext or (ext == best_ext and free and not best_free):
            best, best_ext, best_free = i, ext, free
    if best < 0:
        return base
    new = list(entries)
    new[best] = DATA_AXIS if new[best] is None else _names(new[best]) + (DATA_AXIS,)
    return tuple(new)


def to_jax(key: str, port_tuple) -> tuple:
    """A per-dim tuple (shape or spec) of the port leaf ``key`` in JAX's
    dim order."""
    from distribuuuu_tpu_torch.utils.weights import jax_perm

    return tuple(port_tuple[p] for p in jax_perm(key, len(port_tuple)))


def to_port(key: str, jax_tuple) -> tuple:
    """The inverse of :func:`to_jax`."""
    from distribuuuu_tpu_torch.utils.weights import jax_perm

    out = [None] * len(jax_tuple)
    for j, p in enumerate(jax_perm(key, len(jax_tuple))):
        out[p] = jax_tuple[j]
    return tuple(out)


def leaf_spec(key: str, shape, base_spec, data_size: int, axis_sizes: dict) -> tuple:
    """The ZeRO spec (port dim order) of the port leaf ``key`` of full
    shape ``shape`` and base spec ``base_spec`` (port dim order), chosen
    on its JAX layout."""
    jshape = to_jax(key, tuple(shape))
    jbase = to_jax(key, tuple(base_spec) + (None,) * (len(shape) - len(base_spec)))
    jspec = add_data_axis(jbase, jshape, data_size, axis_sizes)
    jspec = tuple(jspec) + (None,) * (len(shape) - len(jspec))
    return to_port(key, jspec)


# ---------------------------------------------------------------- the plan


def declared_spec(arch: str, key: str, ndim: int, table) -> tuple:
    """The base spec (port dims) the JAX package declares for a leaf, whose
    model-axis names break ``add_data_axis``'s ties whatever the axis
    sizes: the ViT's and the GPT's from their spec table; a CNN's conv
    weights (its squeeze-excite convs excepted) and its head's Dense on
    their output channels, as the JAX package's ConvBN and Dense declare
    them (the port places no CNN on a model axis)."""
    if arch.startswith(("vit", "gpt")):
        return tuple(table.spec_for(key))
    if ndim == 4 and ".se." not in key:
        return ("model", None, None, None)
    if ndim == 2:
        return ("model", None)
    return ()


@dataclass(frozen=True)
class Leaf:
    """One parameter under ZeRO: its name, its rest spec (port dims, full
    tensor), the dim of THIS rank's tensor the data axis splits (None:
    replicated over data), and its gather group (the first integer of its
    JAX path)."""

    name: str
    spec: tuple
    zdim: int | None
    group: int = 0


@dataclass
class Plan:
    """Every parameter's :class:`Leaf` at ``stage`` over a data group of
    ``size`` ranks (this one at ``index``)."""

    stage: int
    size: int
    index: int
    group: object
    leaves: list = field(default_factory=list)

    def sharded(self) -> list:
        return [leaf for leaf in self.leaves if leaf.zdim is not None]


def _first_int(path) -> int:
    m = re.search(r"(\d+)", "/".join(path))
    return int(m.group(1)) if m else 0


def plan_model(model, mesh, stage: int, arch: str, jax_paths: dict | None = None) -> Plan:
    """The ZeRO plan of ``model`` (built whole, then placed by
    ``specs.place_model``) on ``mesh`` at ``stage``. A leaf's full shape
    is its placed shape times the extent of its model/expert split; its
    base spec is the JAX package's declaration (:func:`declared_spec`),
    whatever the axis sizes.
    ``jax_paths`` (``utils/weights.port_path_map``) gives each leaf's
    gather group."""
    from distribuuuu_tpu_torch.parallel.partition import specs

    table = specs.table_for(arch, mesh.topology().moe_axis())
    shards = getattr(model, "shards", {})
    size = mesh.size(DATA_AXIS)
    plan = Plan(int(stage), size, mesh.index(DATA_AXIS), mesh.group(DATA_AXIS))
    for name, p in model.named_parameters():
        base = declared_spec(arch, name, p.dim(), table)
        full = list(p.shape)
        sh = shards.get(name)
        if sh is not None:
            full[sh.dim] *= sh.size
        spec = leaf_spec(name, full, base, size, mesh.sizes) if stage else \
            base + (None,) * (len(full) - len(base))
        zdim = next((d for d, e in enumerate(spec) if DATA_AXIS in _names(e)), None)
        group = _first_int(jax_paths[name]) if jax_paths and name in jax_paths else 0
        plan.leaves.append(Leaf(name, spec, zdim, group))
    return plan


# ---------------------------------------------------------------- gather schedule


def check_gather_ahead(ahead: int) -> int:
    """``ZERO.GATHER_AHEAD``, or JAX's ``ValueError`` below -1."""
    ahead = int(ahead)
    if ahead < -1:
        raise ValueError(
            f"ZERO.GATHER_AHEAD={ahead}: must be -1 (hoist the whole tree), 0 (legacy "
            "per-use gathers), or N >= 1 (hoist the first N block-groups)")
    return ahead


def gather_schedule(plan: Plan, ahead: int = -1) -> list:
    """Per leaf: True where its all-gather is hoisted to step entry (JAX's
    ``specs.gather_schedule``): the stage-3 leaves split over data; -1
    hoists all, 0 none, N >= 1 the leaves of the first N gather groups
    (in group order)."""
    ahead = check_gather_ahead(ahead)
    needs = [plan.stage == 3 and leaf.zdim is not None for leaf in plan.leaves]
    if ahead == -1:
        return needs
    if ahead == 0:
        return [False] * len(needs)
    ordered = sorted({leaf.group for leaf, n in zip(plan.leaves, needs) if n})
    hoisted = set(ordered[:ahead])
    return [bool(n and leaf.group in hoisted) for leaf, n in zip(plan.leaves, needs)]


def gather_bound(plan: Plan, ahead: int = -1) -> int | None:
    """JAX's ``collective_expectations`` ``gather_bound``: the most
    data-axis all-gathers a step may issue. Stage 1: 2 a sharded leaf;
    stage 3 gather-once: one a leaf + 4; per-use: 10 a leaf."""
    n = len(plan.sharded()) if plan.stage else 0
    if plan.stage == 1:
        return 2 * n
    if plan.stage == 3:
        return n + 4 if int(ahead) == -1 else 10 * n
    return None


def staged(stage: int, zdim: int | None) -> bool:
    """Whether a split leaf's parameter shard is a buffer of its own: every
    one at stage 3 (where the parameter rests); at stage 1 a shard on a dim
    other than 0, which is no dense view of the parameter (a dim-0 shard
    of a row-major or channels-last parameter is updated in place)."""
    return zdim is not None and (stage == 3 or zdim != 0)


def predict_resting_bytes(shapes: list, zdims: list, n: int, stage: int,
                          param_itemsize: int, moment_itemsizes=()) -> int:
    """The layout's resting bytes on one rank (what :func:`resting_bytes`
    measures): each parameter whole, or only its 1/n shard where stage 3
    splits it, plus stage 1's staged shard copies (:func:`staged`); each
    gradient buffer whole, or its 1/n shard where stages 1 and 3 split the
    leaf (the reduce-scatter's output); each moment likewise. ``shapes``
    are this rank's (placed) parameter shapes."""
    total = 0
    for shape, z in zip(shapes, zdims):
        numel = 1
        for d in shape:
            numel *= int(d)
        split = stage and z is not None
        part = numel // n if split else numel
        total += (part if stage == 3 and split else numel) * param_itemsize
        total += part * param_itemsize if stage == 1 and staged(stage, z) else 0
        total += part * param_itemsize  # the gradient buffer
        total += sum(part * size for size in moment_itemsizes)
    return total


def resting_bytes(opt) -> int:
    """Bytes of the distinct storages that hold the training state on this
    rank between steps: the parameters as the model holds them (a freed
    stage-3 tensor holds none), the optimizer's gradient buffers and
    moments, and under ZeRO its shard buffers (the parameter shards and the
    reduce-scatter's outputs). A view is counted with its storage."""
    tensors = [*opt.params, *(opt.grads or ()), *(opt.m or ()), *(opt.v or ())]
    if opt.zero is not None:
        tensors += [s for s in opt.zero.pshard if s is not None] + opt.zero.gbufs
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st.nbytes() and st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total


# ---------------------------------------------------------------- packing


def _rows(t: torch.Tensor, zdim: int, n: int, order=None) -> torch.Tensor:
    """``t`` split on ``zdim`` into ``n`` shards, as ``[n, shard numel]``
    rows (row r: shard r in row-major order of its dims permuted by
    ``order``, default their own order)."""
    if order is not None:
        t, zdim = t.permute(order), order.index(zdim)
    k = t.shape[zdim] // n
    return t.unflatten(zdim, (n, k)).movedim(zdim, 0).reshape(n, -1)


def _memory_order(t: torch.Tensor) -> list:
    """``t``'s dims from the outermost in memory to the innermost."""
    return sorted(range(t.dim()), key=lambda d: (-t.stride(d), d))


def _walkable(t: torch.Tensor) -> bool:
    """Dense as the fused update walks a leaf: row-major, or channels last
    for a 4-d conv weight."""
    return t.is_contiguous() or (t.dim() == 4 and t.is_contiguous(
        memory_format=torch.channels_last))


def shard_of(t: torch.Tensor, zdim: int, n: int, r: int) -> torch.Tensor:
    """Shard ``r`` of ``n`` of ``t`` on ``zdim`` (a view)."""
    k = t.shape[zdim] // n
    return t.narrow(zdim, r * k, k)


def _unrows(dst: torch.Tensor, rows: torch.Tensor, zdim: int, n: int) -> None:
    """Write ``[n, shard numel]`` rows back into ``dst`` (inverse of
    :func:`_rows`)."""
    k = dst.shape[zdim] // n
    view = dst.unflatten(zdim, (n, k)).movedim(zdim, 0)
    view.copy_(rows.view(view.shape))


def _buckets(sizes: list, limit: int) -> list:
    """Consecutive index runs of at most ``limit`` bytes (a larger item is
    a run alone)."""
    out, total = [], 0
    for i, nbytes in enumerate(sizes):
        if not out or total + nbytes > limit:
            out.append([])
            total = 0
        out[-1].append(i)
        total += nbytes
    return out


# ---------------------------------------------------------------- the runtime


class ZeroRuntime:
    """The shard buffers of an optimizer's leaves and the step's data-axis
    collectives under ``plan`` (stage 1 or 3 at 2+ data ranks).

    ``pshard[i]``/``gshard[i]`` are contiguous shard buffers of the leaves
    the data axis splits (None elsewhere). ``pshard`` at stage 3 is where
    the parameter rests; at stage 1 it is the parameter's own dim-0 slice
    (a view) or a staged copy of its slice (:func:`staged`). ``gshard[i]``
    is leaf ``i``'s slice of its bucket's reduce-scatter output
    (``gbufs``), kept from step to step. Each collective is joined before
    the next is issued (``ZERO.OVERLAP`` is accepted and recorded, and
    changes neither values nor timing here)."""

    def __init__(self, plan: Plan, params: list, gather_ahead: int = -1):
        from distribuuuu_tpu_torch.parallel import dist

        self.plan, self.params = plan, params
        self.n, self.r, self.group = plan.size, plan.index, plan.group
        self.ahead = int(gather_ahead)
        self.zdims = [leaf.zdim for leaf in plan.leaves]
        self.sharded = [i for i, z in enumerate(self.zdims) if z is not None]
        self.replicated = [i for i, z in enumerate(self.zdims) if z is None]
        self.bucket_bytes = dist.BUCKET_BYTES
        self.staged = [z is not None and (staged(plan.stage, z) or not _walkable(
                           shard_of(p, z, self.n, self.r))) for p, z in zip(params, self.zdims)]
        with torch.no_grad():
            # a copy where staged: a stage-3 parameter's storage is freed
            self.pshard = [None if z is None else
                           shard_of(p.detach(), z, self.n, self.r).clone(
                               memory_format=torch.contiguous_format) if st else
                           shard_of(p.detach(), z, self.n, self.r)
                           for p, z, st in zip(params, self.zdims, self.staged)]
        # the gradient shards are laid out as the parameter shards (the
        # update walks both): rows in the shard's memory order
        self.orders = [None if s is None else _memory_order(s) for s in self.pshard]
        sizes = [params[i].numel() * params[i].element_size() for i in self.sharded]
        self.buckets = [[self.sharded[j] for j in run]
                        for run in _buckets(sizes, self.bucket_bytes)]
        self.gshard, self.gbufs = [None] * len(params), []
        for idx in self.buckets:
            out = torch.empty(sum(self.pshard[i].numel() for i in idx),
                              dtype=params[idx[0]].dtype, device=params[idx[0]].device)
            off = 0
            for i in idx:
                shard, order = self.pshard[i], self.orders[i]
                k = shard.numel()
                self.gshard[i] = out[off:off + k].view([shard.shape[d] for d in order]) \
                    .permute([order.index(d) for d in range(shard.dim())])
                off += k
            self.gbufs.append(out)
        self.hoist = gather_schedule(plan, self.ahead)
        self.per_use = [plan.stage == 3 and z is not None and not h
                        for z, h in zip(self.zdims, self.hoist)]
        self.resting = False        # stage 3: the full parameters are freed
        self.live = [True] * len(params)   # the full tensor holds its values
        self._ptr: dict = {}        # storage pointer -> leaf (per-use leaves)
        self._hooks: list = []
        self._armed: set = set()    # ids of the modules whose hooks act
        self._held = 0              # gathered() depth: per-use hooks do nothing

    def __deepcopy__(self, memo):
        return self  # buffers and groups are this rank's, shared by model copies

    # -- collectives ---------------------------------------------------------

    def reduce(self, grads: list, full: list) -> None:
        """The gradient mean over the data group from the step's gradients
        ``grads``: the split leaves reduce-scattered into ``gshard``
        (packed rows, one collective a bucket), the others copied into
        their full buffers ``full`` and all-reduced there
        (``dist.all_reduce_grads``'s buckets)."""
        import torch.distributed as tdist

        from distribuuuu_tpu_torch.parallel import dist

        for idx, out in zip(self.buckets, self.gbufs):
            packed = torch.cat([_rows(grads[i], self.zdims[i], self.n, self.orders[i])
                                for i in idx], 1)
            tdist.reduce_scatter_tensor(out, packed.reshape(-1), group=self.group)
            out /= self.n
        if self.replicated:
            for i in self.replicated:
                full[i].copy_(grads[i])
            dist.all_reduce_grads([full[i] for i in self.replicated], self.group)

    def _all_gather(self, idx: list, sources, targets) -> None:
        """All-gather the shards ``sources(i)`` of leaves ``idx`` over the
        data group into ``targets(i)`` (full tensors), one collective a
        bucket; counts each in ``dist.zero_gathers``."""
        import torch.distributed as tdist

        from distribuuuu_tpu_torch.parallel import dist

        sizes = [self.pshard[i].numel() * self.pshard[i].element_size() * self.n
                 for i in idx]
        for run in _buckets(sizes, self.bucket_bytes):
            ids = [idx[j] for j in run]
            row = torch.cat([sources(i).reshape(-1) for i in ids])
            out = torch.empty((self.n, row.numel()), dtype=row.dtype, device=row.device)
            tdist.all_gather(list(out.unbind(0)), row, group=self.group)
            dist.zero_gathers.count += 1
            off = 0
            for i in ids:
                n = self.pshard[i].numel()
                _unrows(targets(i), out[:, off:off + n], self.zdims[i], self.n)
                off += n

    # -- stage 1 -------------------------------------------------------------

    @torch.no_grad()
    def stage_params(self) -> None:
        """Stage 1: copy the staged leaves' slices of the replicated
        parameters into their shard buffers, for the update."""
        if self.plan.stage == 1:
            for i in self.sharded:
                if self.staged[i]:
                    self.pshard[i].copy_(shard_of(self.params[i], self.zdims[i], self.n,
                                                  self.r))

    @torch.no_grad()
    def publish(self) -> None:
        """After the update: stage 1 all-gathers the updated shards into
        the replicated parameters; stage 3 frees the gathered tensors."""
        if self.plan.stage == 1:
            self._all_gather(self.sharded, lambda i: self.pshard[i], lambda i: self.params[i])
        else:
            self.free(self.sharded)

    # -- stage 3 -------------------------------------------------------------

    def _alloc(self, i: int) -> torch.Tensor:
        p = self.params[i]
        st = p.untyped_storage()
        need = p.numel() * p.element_size()
        if st.nbytes() != need:
            st.resize_(need)
        return p

    @torch.no_grad()
    def gather(self, idx: list) -> None:
        """Stage 3: give the leaves ``idx`` (those not already live) their
        full tensors again, all-gathered from the shards."""
        idx = [i for i in idx if not self.live[i]]
        if not idx:
            return
        for i in idx:
            self._alloc(i)
        self._all_gather(idx, lambda i: self.pshard[i], lambda i: self.params[i])
        for i in idx:
            self.live[i] = True
            if self.per_use[i]:
                self._ptr[self.params[i].untyped_storage().data_ptr()] = i

    def free(self, idx: list) -> None:
        """Stage 3: free the full tensors of the leaves ``idx``."""
        if self.plan.stage != 3:
            return
        for i in idx:
            if self.live[i]:
                st = self.params[i].untyped_storage()
                self._ptr.pop(st.data_ptr(), None)
                st.resize_(0)
                self.live[i] = False

    @torch.no_grad()
    def rest(self, model=None) -> None:
        """Stage 3: take the shards from the (full, identical on every data
        rank) parameters, free the full tensors, and arm the per-use
        hooks on ``model``. Idempotent."""
        if self.plan.stage != 3 or self.resting:
            return
        for i in self.sharded:
            self.pshard[i].copy_(shard_of(self.params[i], self.zdims[i], self.n, self.r))
        self.free(self.sharded)
        self.resting = True
        if model is not None and not self._hooks and any(self.per_use):
            self._arm(model)

    def begin_step(self) -> None:
        """Stage 3, at step entry: gather the hoisted leaves."""
        if self.resting:
            self.gather([i for i in self.sharded if self.hoist[i]])

    @contextlib.contextmanager
    def gathered(self, write_back: bool = False):
        """Every leaf full for the block (an eval, a save, a load), one
        gather a bucket; the per-use hooks stand down. ``write_back``
        takes the shards from the parameters at the exit (after a load).
        A no-op outside stage 3's rest."""
        if not self.resting:
            yield
            return
        self.gather(self.sharded)
        self._held += 1
        try:
            yield
        finally:
            self._held -= 1
            if write_back:
                with torch.no_grad():
                    for i in self.sharded:
                        self.pshard[i].copy_(shard_of(self.params[i], self.zdims[i],
                                                      self.n, self.r))
            if not self._held:
                self.free(self.sharded)

    # -- per-use gathers (stage 3, GATHER_AHEAD >= 0) ---------------------------

    def _arm(self, model) -> None:
        """Frame hooks on every module of ``model``: a per-use leaf an op
        of the step's forward reads is gathered there (:class:`_UseMode`)
        and freed when the innermost module running at that op returns
        (a layer that is no module, as the fused ConvBN, uses its block's
        frame)."""
        self._by_id = {id(p): i for i, p in enumerate(self.params)}
        self._frames: list = []
        self._tracking = False
        for mod in model.modules():
            self._armed.add(id(mod))
            self._hooks.append(mod.register_forward_pre_hook(
                lambda m, a: self._push(m)))
            self._hooks.append(mod.register_forward_hook(
                lambda m, a, o: self._pop(m)))

    def _push(self, mod) -> None:
        if self._tracking and id(mod) in self._armed:
            self._frames.append([])

    def _pop(self, mod) -> None:
        if self._tracking and id(mod) in self._armed and self._frames:
            self.free(self._frames.pop())

    def _on_use(self, tensors) -> None:
        """An op reads ``tensors``: gather the per-use leaves among them
        that are not live, owned by the innermost frame."""
        ids = []
        for t in tensors:
            i = self._by_id.get(id(t))
            if i is not None and self.per_use[i] and not self.live[i]:
                ids.append(i)
        if ids:
            self.gather(ids)
            if self._frames:
                self._frames[-1].extend(ids)

    def _pack(self, t: torch.Tensor):
        if not self._ptr or t.device.type == "meta":
            return t
        i = self._ptr.get(t.untyped_storage().data_ptr())
        if i is None:
            return t
        return ("zero_leaf", i, tuple(t.shape), tuple(t.stride()), t.storage_offset())

    def _unpack(self, packed):
        if not (isinstance(packed, tuple) and packed and packed[0] == "zero_leaf"):
            return packed
        _, i, shape, stride, offset = packed
        p = self.params[i]
        if self.live[i]:
            full = p.detach()
        else:
            full = torch.empty_strided(p.shape, p.stride(), dtype=p.dtype, device=p.device)
            with torch.no_grad():
                self._all_gather([i], lambda j: self.pshard[j], lambda j: full)
        return full.as_strided(shape, stride, offset)

    @contextlib.contextmanager
    def use_scope(self):
        """The context of a step's forward under per-use gathers: each
        per-use leaf is gathered at the first op that reads it and freed
        when its frame returns; a saved per-use leaf is kept as its index
        and gathered again where the backward reads it. A no-op when every
        leaf is hoisted (or outside stage 3's rest)."""
        if not (self.resting and any(self.per_use)) or self._held:
            yield
            return
        self._tracking, self._frames = True, [[]]
        try:
            with _UseMode(self), torch.autograd.graph.saved_tensors_hooks(
                    self._pack, self._unpack):
                yield
        finally:
            self._tracking = False
            for frame in self._frames:
                self.free(frame)
            self._frames = []

    # -- state ---------------------------------------------------------------

    @torch.no_grad()
    def full_tensors(self, bufs: list) -> list:
        """Each leaf's tensor of ``bufs`` (shards of the split leaves, the
        others whole: the optimizer's moments) put together into the full
        (placed) tensors, on every data rank: a collective, one a bucket."""
        out = [t if z is None else torch.empty(p.shape, dtype=t.dtype, device=t.device)
               for t, p, z in zip(bufs, self.params, self.zdims)]
        self._all_gather(self.sharded, lambda i: bufs[i], lambda i: out[i])
        return out

    def shard_moment(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full (placed) tensor ``full`` of leaf
        ``i`` (a view; ``full`` itself for a replicated leaf)."""
        z = self.zdims[i]
        return full if z is None else shard_of(full, z, self.n, self.r)


def runtime_from_cfg(model, arch: str | None = None) -> ZeroRuntime | None:
    """The :class:`ZeroRuntime` of ``model`` (built and placed) under the
    config's ``MESH.ZERO`` and ``ZERO.GATHER_AHEAD`` on
    this process's mesh; None when no leaf is split over data (stage 0,
    one data rank: the base layout, as JAX's ``add_data_axis`` returns
    it at one data rank)."""
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.parallel import mesh as mesh_lib
    from distribuuuu_tpu_torch.utils.weights import port_path_map

    mesh, stage = mesh_lib.current(), int(cfg.MESH.ZERO)
    if stage == 0 or mesh.size(DATA_AXIS) <= 1:
        return None
    plan = plan_model(model, mesh, stage, arch or cfg.MODEL.ARCH,
                      port_path_map(model.state_dict()))
    if not plan.sharded():
        return None
    return ZeroRuntime(plan, [p for _, p in model.named_parameters()],
                       int(cfg.ZERO.GATHER_AHEAD))


def gathered(model, write_back: bool = False):
    """:meth:`ZeroRuntime.gathered` of ``model``'s runtime, or a no-op."""
    rt = getattr(model, "zero_runtime", None)
    return contextlib.nullcontext() if rt is None else rt.gathered(write_back)


_logged_schedules: set = set()


def log_schedule(plan: Plan, overlap: bool, ahead: int) -> dict | None:
    """One ``zero.schedule`` record (``metrics.jsonl``) per distinct
    schedule, with JAX's fields and dedup (``lowering._log_zero_schedule``):
    the stage, the parameter leaves, those resting split over data, the
    entry gathers hoisted, and the two knobs. Returns the record's fields,
    or None when this schedule was recorded already."""
    from distribuuuu_tpu_torch.utils.jsonlog import metrics_log

    sharded = len(plan.sharded())
    key = (int(plan.stage), sharded, sum(gather_schedule(plan, ahead)), bool(overlap),
           int(ahead))
    if key in _logged_schedules:
        return None
    _logged_schedules.add(key)
    fields = dict(stage=key[0], leaves=len(plan.leaves), sharded=key[1], hoisted=key[2],
                  overlap=key[3], gather_ahead=key[4])
    metrics_log("zero.schedule", **fields)
    return fields


class _UseMode(torch.overrides.TorchFunctionMode):
    """Sees every torch call of the step's forward: a per-use ZeRO-3 leaf
    among its arguments is gathered before the call runs."""

    def __init__(self, rt: ZeroRuntime):
        super().__init__()
        self.rt = rt

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = torch.utils._pytree.tree_leaves((args, kwargs))
        self.rt._on_use([t for t in flat if isinstance(t, torch.nn.Parameter)])
        return func(*args, **kwargs)


def kept(state: dict, model) -> dict:
    """``state`` (``specs.full_train_state`` taken inside :func:`gathered`)
    with the model's tensors copied when its parameters rest as ZeRO-3
    shards: the gathered tensors it names are freed at the block's exit."""
    rt = getattr(model, "zero_runtime", None)
    if rt is None or not rt.resting:
        return state
    return {**state, "model": {k: v.clone() if torch.is_tensor(v) else v
                               for k, v in state["model"].items()}}
