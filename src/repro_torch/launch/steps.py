"""Step-function factories: train_step / prefill_step / decode_step with
their sharding specs, and ``meta``-device stand-ins of a cell's inputs and
state (counterpart of ``repro/launch/steps.py``).

The trainer and the server build their steps here. ``cell_shardings``
gives a cell's stand-ins with their specs (``parallel/sharding.py``) on a
mesh; ``make_decode_step`` takes the JAX signature's mesh and
sequence-sharding axis.

``make_train_step(cfg, tcfg, mesh, sc)`` is the training step on a mesh,
SPMD (one process a rank). The JAX package hands GSPMD a step over inputs
placed by ``param_specs`` / ``batch_spec``; here the step places its
collectives itself, as ZeRO-3 with expert parallelism does. It takes and
returns this rank's blocks of the parameters (``param_specs``) and of
``master`` / ``m`` / ``v`` (``param_specs(zero=True)``), and its block of
the batch (``batch_spec``):

- every leaf is gathered at use by ``comm.all_gather_dim``: a stacked
  leaf one layer slice at a time, when the layer (the remat unit) takes
  it, and again in remat's recompute; an unstacked one (``embed``) whole
  for the step. The MoE expert leaves stay on their ``model`` band and
  run through ``moe_apply_ep``;
- the gather's backward sums the gradient over an axis whose ranks saw
  different tokens (the batch axes) and keeps this rank's slice along
  one where every rank computed the same gradient (``model`` outside the
  expert region); a leaf the batch axes do not shard has its gradient
  summed over them after the backward (reduced and scattered where the
  optimizer layout shards it further). Each rank's loss is its tokens'
  share of the global-batch mean, so the sums give the one-device
  gradient;
- AdamW runs on the optimizer blocks; the global norm sums each block's
  squares over the axes its spec names, never over those it is
  replicated along, in rank order, so every rank clips alike; where the
  optimizer layout shards a leaf further than the parameter layout (the
  expert leaves over ``data``), the new parameter block is gathered back
  from the master blocks.

Dense compute along ``model`` is replicated, not split by heads as the
JAX GSPMD step splits it: the reduced configs' specs cut a kv head across
ranks (``wk`` 2 heads x 32 columns over ``model`` 4), so a head-aligned
split does not always exist (ROADMAP queue 2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

from repro_torch.core.butterfly import tree_leaves
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.models.config import ModelConfig, ShardingConfig, TrainConfig
from repro_torch.models.model import build_model, sample_topk
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     lr_schedule)
from repro_torch.parallel import act, comm
from repro_torch.parallel.sharding import (NamedSharding, batch_spec,
                                           cache_specs, layer_dims,
                                           param_specs, shard_leaf,
                                           spec_axes, tree_map_like)

__all__ = ["SHAPES", "LONG_OK", "long_500k_applicable", "make_train_step",
           "make_prefill_step", "make_decode_step", "input_specs",
           "abstract_state", "abstract_cache", "shardings_for",
           "cell_shardings", "MeshLayout", "loss_and_grads"]

# ---------------------------------------------------------------------------
# shapes of the assigned input grid
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# archs whose decode state is sub-quadratic -> long_500k applies
LONG_OK = {"zamba2-2.7b", "xlstm-1.3b", "mixtral-8x22b"}


def long_500k_applicable(cfg: ModelConfig) -> bool:
    return cfg.name in LONG_OK


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------

def loss_and_grads(model, params, batch):
    """``(loss, aux, grads)``: ``model.train_loss`` and its gradient with
    respect to every leaf of ``params`` (a list in ``tree_leaves`` order;
    zeros for a leaf the loss does not reach). The leaves require grad
    only for the call."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, aux = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    sc: Optional[ShardingConfig] = None):
    """``(model, train_step)``; ``train_step(params, opt, batch)`` takes the
    loss and its gradient, the learning rate of ``opt.step`` and one AdamW
    update (in place), and returns ``(params, opt, metrics)`` with
    ``loss``, ``lr``, ``grad_norm`` and ``ce`` as 0-d device tensors.

    With ``mesh`` (and ``sc``, by default ``ShardingConfig()``) the step
    runs on this rank's blocks (the module's doc); ``train_step.layout``
    (a :class:`MeshLayout`) makes them. The metrics are the global batch's,
    the same bits on every rank."""
    model = build_model(cfg)
    if mesh is not None:
        layout = MeshLayout(cfg, tcfg, mesh, sc or ShardingConfig(), model)

        def mesh_step(params, opt_state, batch):
            return layout.train_step(params, opt_state, batch)
        mesh_step.layout = layout
        return model, mesh_step

    def train_step(params, opt_state, batch):
        loss, aux, grads = loss_and_grads(model, params, batch)
        lr = lr_schedule(opt_state.step, tcfg.lr, tcfg.warmup_steps,
                         tcfg.total_steps)
        params, opt_state, metrics = adamw_update(
            grads, opt_state, params, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
        metrics = dict(metrics, loss=loss, lr=lr, **aux)
        return params, opt_state, metrics

    return model, train_step


def make_prefill_step(cfg: ModelConfig):
    model = build_model(cfg)

    def prefill_step(params, batch):
        return model.prefill(params, batch, max_seq=0)

    return model, prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None, kv_shard_axis: str = ""):
    """``decode_step(params, token, pos, cache, generator)`` -> ``(next
    tokens, cache)``: one model step, then ``sample_topk(k=64)`` on the
    ``torch`` top-k. With ``mesh`` and ``kv_shard_axis`` the caches are
    this rank's blocks of sequence-sharded caches."""
    model = build_model(cfg)

    def decode_step(params, token, pos, cache, generator):
        logits, cache = model.decode_step(params, token, pos, cache,
                                          mesh=mesh,
                                          kv_shard_axis=kv_shard_axis)
        nxt = sample_topk(generator, logits, k=64, use_flims=False)
        return nxt, cache

    return model, decode_step


# ---------------------------------------------------------------------------
# abstract inputs and state of a (cfg, shape) cell, on the meta device
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape_name: str):
    """``meta`` stand-ins for every model input of the cell."""
    s = SHAPES[shape_name]
    return make_batch_specs(cfg, s["seq_len"], s["global_batch"])


def abstract_state(cfg: ModelConfig, shape_name: str, with_opt: bool = True):
    """``(model, params, opt or None)`` on the ``meta`` device: shapes and
    dtypes, no allocation."""
    model = build_model(cfg)
    params = model.init(torch.Generator(), device="meta")
    if not with_opt:
        return model, params, None
    return model, params, adamw_init(params)


def shardings_for(tree, spec_tree, mesh):
    """A ``NamedSharding(mesh, spec)`` at every leaf of ``tree``."""
    return tree_map_like(lambda _, s: NamedSharding(mesh, s), tree,
                         spec_tree)


def cell_shardings(cfg: ModelConfig, shape_name: str, mesh,
                   sc: ShardingConfig):
    """The cell's ``meta`` stand-ins, each with its tree of shardings:
    ``{"params": (params, shardings), ...}`` and, by the shape's kind,
    ``opt`` (the ZeRO layout, ``zero=True``) and ``batch`` (train),
    ``batch`` (prefill), or ``cache``, ``token``, ``pos`` and ``key``
    (decode). ``mesh`` may be an ``AbstractMesh``."""
    s = SHAPES[shape_name]
    kind = s["kind"]
    model, params, opt = abstract_state(cfg, shape_name,
                                        with_opt=(kind == "train"))
    out = {"params": (params, shardings_for(
        params, param_specs(params, sc, mesh), mesh))}
    if kind == "train":
        ospec = AdamWState((), param_specs(opt.m, sc, mesh, zero=True),
                           param_specs(opt.v, sc, mesh, zero=True),
                           param_specs(opt.master, sc, mesh, zero=True))
        out["opt"] = (opt, shardings_for(opt, ospec, mesh))
    if kind in ("train", "prefill"):
        batch = input_specs(cfg, shape_name)
        out["batch"] = (batch, shardings_for(
            batch, batch_spec(batch, sc, mesh), mesh))
    if kind == "decode":
        cache = abstract_cache(cfg, shape_name)
        out["cache"] = (cache, shardings_for(
            cache, cache_specs(cache, sc, mesh), mesh))
        B = s["global_batch"]
        dp = tuple(a for a in sc.data_axes if a in mesh.axis_names)
        n = 1
        for a in dp:
            n *= mesh.shape[a]
        tok_spec = ((dp[0] if len(dp) == 1 else dp),) \
            if B % max(1, n) == 0 else ()
        meta = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                                device="meta")
        out["token"] = (meta((B,), torch.int32),
                        NamedSharding(mesh, tok_spec))
        out["pos"] = (meta((B,), torch.int32), NamedSharding(mesh, tok_spec))
        out["key"] = (meta((2,), torch.uint32), NamedSharding(mesh, ()))
    return out


# ---------------------------------------------------------------------------
# the training step on a mesh
# ---------------------------------------------------------------------------

@dataclass
class _Leaf:
    """How one parameter leaf is laid out and moved by the mesh step."""
    path: Tuple[str, ...]
    pspec: tuple                    # the parameter block's spec
    ospec: tuple                    # the optimizer blocks' spec (ZeRO)
    depth: int                      # leading stacked dims
    # (dim, axis, grad rule) gathered at use, in order
    gathers: List[Tuple[int, str, str]] = field(default_factory=list)
    # after the backward: ("psum", axis) / ("rs", dim, axis) /
    # ("slice", dim, axis), from the parameter block's gradient to the
    # optimizer block's
    post: List[tuple] = field(default_factory=list)


class _Stack:
    """A stacked leaf's block seen as its layers: entry ``i`` is layer
    ``i``'s slice, gathered whole over the leaf's gather axes when it is
    taken (a stack of more dims gives a stack of one fewer)."""

    def __init__(self, block, gathers, depth, mesh):
        self.block, self.gathers, self.depth, self.mesh = \
            block, gathers, depth, mesh

    def __getitem__(self, i):
        sub = [(d - 1, a, r) for d, a, r in self.gathers]
        if self.depth > 1:
            return _Stack(self.block[i], sub, self.depth - 1, self.mesh)
        return _gather(self.block[i], sub, self.mesh)


def _gather(x, gathers, mesh):
    for dim, axis, rule in gathers:
        x = comm.all_gather_dim(x, dim, axis, mesh, grad=rule)
    return x


class MeshLayout:
    """The specs of a config's parameters, optimizer state and batch on a
    mesh, and the training step over this rank's blocks of them (the
    module's doc). ``init(gen)`` draws the parameter blocks from the
    one-process init's generator; ``opt_init`` makes the optimizer blocks;
    ``batch_block`` cuts a global batch; ``param_shardings`` /
    ``opt_shardings`` are the checkpoint manager's ``shardings``."""

    def __init__(self, cfg, tcfg, mesh, sc: ShardingConfig, model=None):
        self.cfg, self.tcfg, self.mesh, self.sc = cfg, tcfg, mesh, sc
        self.model = model or build_model(cfg)
        full = self.model.init(torch.Generator(), device="meta")
        self.full = full
        self.pspec = param_specs(full, sc, mesh)
        self.ospec = param_specs(full, sc, mesh, zero=True)
        batch = make_batch_specs(cfg, tcfg.seq_len, tcfg.global_batch)
        self.bspec = batch_spec(batch, sc, mesh)
        # the axes the batch is split over: their ranks see other tokens
        self.varying = spec_axes(self.bspec["tokens"][0])
        tp = sc.model_axis if sc.model_axis in mesh.axis_names else None
        self.ep = (cfg.family == "moe" and cfg.moe_path == "ep"
                   and tp is not None
                   and cfg.n_experts % mesh.axis_size(tp) == 0)
        self.by_path = {}
        self._plan_tree(full, self.pspec, self.ospec, ())

    # ---------------------------------------------------------------- plan
    def _plan_tree(self, tree, ps, os_, path):
        if isinstance(tree, dict):
            for k in tree:
                self._plan_tree(tree[k], ps[k], os_[k], path + (str(k),))
        else:
            self.by_path[path] = self._plan(path, tree, ps, os_)

    def _plan(self, path, t, ps, os_) -> _Leaf:
        mesh, tp = self.mesh, self.sc.model_axis
        depth = layer_dims(path, tuple(t.shape), self.sc)
        expert = "moe" in path and path[-1] in ("wi", "wg", "wo")
        lf = _Leaf(path, ps, os_, depth)
        for d, (pe, oe) in enumerate(zip(ps, os_)):
            if pe is not None and pe != oe:
                raise NotImplementedError(
                    f"{'/'.join(path)}: parameter spec {ps} is not a part "
                    f"of the optimizer spec {os_}")
        for d, e in enumerate(ps):
            for a in reversed(spec_axes(e)):
                if mesh.axis_size(a) == 1:
                    continue
                if expert and self.ep and a == tp and d == depth:
                    continue              # the expert band stays local
                varies = a in self.varying or (expert and self.ep
                                               and a == tp)
                lf.gathers.append((d, a, "sum" if varies else "slice"))
        named = {a for e in ps for a in spec_axes(e)}
        varying = list(self.varying)
        if expert and self.ep and tp not in named:
            varying.append(tp)            # whole stacks, a band's gradient
        for a in varying:
            if a in named or mesh.axis_size(a) == 1:
                continue
            dims = [d for d, e in enumerate(os_) if a in spec_axes(e)]
            lf.post.append(("rs", dims[0], a) if dims else ("psum", a))
        for d, (pe, oe) in enumerate(zip(ps, os_)):
            if pe is None and oe is not None:
                for a in spec_axes(oe):
                    if a not in varying and mesh.axis_size(a) > 1:
                        lf.post.append(("slice", d, a))
        return lf

    def plans(self, tree) -> List[_Leaf]:
        """The leaves' plans in ``tree_leaves(tree)`` order (a tree of the
        parameters' structure, its dicts in any key order)."""
        out = []

        def walk(t, path):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, path + (str(k),))
            else:
                out.append(self.by_path[path])
        walk(tree, ())
        return out

    # --------------------------------------------------------- the blocks
    def _cut(self, path, t, n):
        """``decoder_init``'s cut: this rank's part of one drawn leaf."""
        spec = self.by_path[path].pspec
        return shard_leaf(t, spec[1:] if n else spec, self.mesh)

    def init(self, gen: torch.Generator, device=None):
        """This rank's parameter blocks of ``model.init(gen)``: the same
        draws from the same generator, each leaf cut as it is drawn."""
        return self.model.init(gen, device=device, cut=self._cut)

    def _own(self, x, d: int, a: str):
        """This rank's block of ``x`` along dim ``d`` split over ``a``."""
        m = x.shape[d] // self.mesh.axis_size(a)
        return x.narrow(d, self.mesh.axis_index(a) * m, m)

    def _to_opt(self, lf, x):
        """The optimizer layout's block of a parameter-layout block (a
        view)."""
        for op in lf.post:
            if op[0] != "psum":
                x = self._own(x, op[1], op[2])
        return x

    def opt_init(self, params) -> AdamWState:
        """Zero moments and float32 master blocks (the ZeRO layout) of
        the parameter blocks ``params``."""
        masters = [self._to_opt(lf, p).to(torch.float32, copy=True)
                   for lf, p in zip(self.plans(params), tree_leaves(params))]
        it = iter(masters)
        master = tree_map_like(lambda _: next(it), params)
        zeros = lambda: tree_map_like(torch.zeros_like, master)
        dev = masters[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          zeros(), zeros(), master)

    def batch_block(self, batch):
        """This rank's block of a global batch."""
        return tree_map_like(lambda t, s: shard_leaf(t, s, self.mesh),
                             batch, {k: self.bspec[k] for k in batch})

    def param_shardings(self):
        return shardings_for(self.full, self.pspec, self.mesh)

    def opt_shardings(self):
        zs = lambda: shardings_for(self.full, self.ospec, self.mesh)
        return AdamWState(NamedSharding(self.mesh, ()), zs(), zs(), zs())

    def _view(self, params):
        """The tree the model reads: each leaf gathered (an unstacked one
        now, a stacked one a layer at a time through :class:`_Stack`),
        the expert bands as they are."""
        out = []
        for lf, b in zip(self.plans(params), tree_leaves(params)):
            if not lf.gathers:
                out.append(b)
            elif lf.depth:
                out.append(_Stack(b, lf.gathers, lf.depth, self.mesh))
            else:
                out.append(_gather(b, lf.gathers, self.mesh))
        it = iter(out)
        return tree_map_like(lambda _: next(it), params)

    # ------------------------------------------------------------ the step
    def _data_psum(self, x):
        for a in self.varying:
            x = comm.psum(x, a, self.mesh)
        return x

    def loss_and_grads(self, params, batch):
        """``(loss, aux, grads)`` of the global batch from this rank's
        blocks: the loss and ``aux`` summed over the batch axes (the same
        bits on every rank), ``grads`` each leaf's optimizer-layout block
        of the one-device gradient (a list in ``tree_leaves`` order)."""
        mesh = self.mesh
        leaves = tree_leaves(params)
        mask = batch.get("mask")
        n_local = (mask.float().sum() if mask is not None else
                   torch.tensor(float(batch["targets"].numel()),
                                device=batch["targets"].device))
        n_global = self._data_psum(n_local)
        share = torch.clamp(n_local, min=1.0) / torch.clamp(n_global,
                                                             min=1.0)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, aux = self.model.train_loss(self._view(params), batch)
            grads = torch.autograd.grad(loss * share, leaves,
                                        allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        out = []
        for lf, g, p in zip(self.plans(params), grads, leaves):
            g = torch.zeros_like(p) if g is None else g
            for op in lf.post:
                if op[0] == "psum":
                    g = comm.psum(g, op[1], mesh)
                elif op[0] == "rs":
                    g = comm.reduce_scatter(g, op[1], op[2], mesh)
                else:
                    g = self._own(g, op[1], op[2])
            out.append(g)
        loss = self._data_psum(loss.detach() * share)
        aux = {k: self._data_psum(v.detach() * share) for k, v in aux.items()}
        return loss, aux, out

    def global_norm(self, grads, plans) -> torch.Tensor:
        """The norm of the whole gradient from the optimizer blocks
        ``grads`` (leaves of the layouts ``plans``): each block's float32
        square sum summed over the axes its spec names (one ``psum`` per
        axis for the leaves that share it), then over the leaves in tree
        order: the same bits on every rank."""
        sq = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
        groups = {}
        for i, lf in enumerate(plans):
            axes = tuple(a for e in lf.ospec for a in spec_axes(e)
                         if self.mesh.axis_size(a) > 1)
            groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            if not axes:
                continue
            v = torch.stack([sq[i] for i in idx])
            for a in axes:
                v = comm.psum(v, a, self.mesh)
            for j, i in enumerate(idx):
                sq[i] = v[j]
        total = sq[0]
        for s_ in sq[1:]:
            total = total + s_
        return torch.sqrt(total)

    def _put(self, lf, w, p):
        """Parameter block ``p`` from master block ``w``: cast, and where
        the optimizer layout cuts further, gathered back."""
        x = w.to(p.dtype)
        for op in reversed(lf.post):
            if op[0] != "psum":
                x = comm.all_gather_dim(x, op[1], op[2], self.mesh)
        p.copy_(x)

    def train_step(self, params, opt_state, batch):
        """One step on this rank's blocks (``make_train_step``)."""
        tc = self.tcfg
        with act.context(self.mesh, self.sc.data_axes, self.sc.model_axis):
            plans = self.plans(params)
            loss, aux, grads = self.loss_and_grads(params, batch)
            norm = self.global_norm(grads, plans)
            lr = lr_schedule(opt_state.step, tc.lr, tc.warmup_steps,
                             tc.total_steps)
            params, opt_state, metrics = adamw_update(
                grads, opt_state, params, lr=lr, b1=tc.b1, b2=tc.b2,
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
                norm=norm, put=lambda i, w, p: self._put(plans[i], w, p))
        return params, opt_state, dict(metrics, loss=loss, lr=lr, **aux)


def abstract_cache(cfg: ModelConfig, shape_name: str):
    s = SHAPES[shape_name]
    model = build_model(cfg)
    B, W = s["global_batch"], s["seq_len"]
    if cfg.arch_kind == "encdec":
        return model.init_cache(B, W, enc_len=1500, device="meta")
    return model.init_cache(B, W, device="meta")
