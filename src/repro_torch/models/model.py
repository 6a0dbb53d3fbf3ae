"""Decoder LM: embed -> block groups -> norm -> LM head, for training
(``forward``/``loss_fn``/``make_train_step``) and serving (``prefill``/
``decode_step``). Twin of ``repro.models.model``.

Parameters keep the reference's tree: ``embed`` (token models only), one
``g{i}`` per layout group with every leaf stacked on a leading "layers"
dim, ``final_norm`` and ``lm_head`` (untied, or a frame model's). A frame
model (``embed_input="frames"``) reads precomputed embeddings
``batch["frames"]`` (B, S, d) in place of ``batch["tokens"]``.
``model_init`` draws the parameters in f32, one layer at a time, and
stores the leaves that are only ever cast to the activations' dtype in
``run.activations_dtype``, which a model too large for the card in f32
needs. The reference scans each group with ``lax.scan``; the
port loops over the layers. Serving indexes the stacked weights; training
unbinds each stacked leaf once per forward, so that autograd stacks each
leaf's gradient once (a per-layer index would build a zero tensor of the
whole stack in every layer's backward). ``run.remat == "block"``
recomputes each layer in the backward (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` of the scan body; the attention forward
kernel then runs twice a layer); any other value keeps the activations.
``model_init`` returns the reference's logical-axis spec tree beside the
parameters, which ``launch.specs`` and ZeRO-1 training (``train``)
resolve on a mesh. The model runs on rank-local tensors and sets no
sharding constraints; under ``moe_impl="ep"`` with a mesh in
``shardctx`` its MoE layers run expert-parallel (``dist.ep``).
In training on a mesh whose ``model`` axis has more than one rank
(``shardctx.tensor_parallel``) each rank's ``forward`` runs on its ``model``
blocks of the parameters: the layers split as ``models.layers`` says, the
embedding looked up in each rank's vocabulary block, and the LM head and
the cross-entropy vocab-parallel (``_lse_and_label``: the max, the
sum of exponentials and the label's logit reduced over the ranks, the
padded vocabulary masked in each block). ``cache_axes`` gives the
reference's logical axes of the caches for
``dist.sharding``. Caches are per layer: ``caches["g{i}"]`` is a list with
one dict per layer of the group (the reference stacks them); decode writes
KV caches in place.

Serving on a mesh (``shardctx.set_ctx(mesh, blocks=True)``): ``prefill``,
``init_caches`` and ``decode_step`` take this rank's blocks of the
parameters (``dist.sharding.tree_shardings`` of the spec tree) and of the
caches (``CACHE_RULES`` of ``cache_axes``: batch over the data axes, the
sequence over ``model``, every head; the SSD conv window's channels over
``model``, its state whole) and the whole batch, of which each rank runs
its rows (as the reference shards ``("batch", ...)`` inputs); the layers
run under ``shardctx.serving_on`` on the rank's ``model`` blocks, and the
returned last-token logits are whole on every rank (gathered over the
vocabulary and the rows), as the reference's ``out_shardings=None``
leaves them. A cache length that the ``model`` axis does not divide
raises (``TensorParallel.seq_block``).
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch

from ..device import resolve_device
from ..shardctx import tensor_parallel
from torch.utils.checkpoint import checkpoint

from .blocks import (
    block_apply, block_decode, block_init, block_init_cache, block_prefill,
)
from .config import ArchConfig, RunConfig
from .layers import (
    Params, Specs, embed_apply, embed_init, lm_head_apply, norm_apply,
    norm_init, stack_init, tree_leaves, tree_map,
)
from .rope import sinusoidal


def padded_vocab(cfg: ArchConfig, run: RunConfig) -> int:
    r = run.vocab_round
    return (cfg.vocab + r - 1) // r * r


# the leaves whose every use is ``.to(x.dtype)`` of an activation: dense
# weights and biases, the MoE expert stacks, the embedding and LM-head
# tables. Norms, the router (``route`` multiplies in f32), MLA's ``wukv``
# (``mla_decode`` absorbs it in f32) and the SSD block's conv, ``A_log``,
# ``D`` and ``dt_bias`` are read in f32.
_ACTIVATION_LEAVES = ("w", "b", "table", "wi", "wg", "wo",
                      "shared_wi", "shared_wg", "shared_wo")
_READ_IN_F32 = ("router", "wukv")


def _stored_as_activations(path: tuple[str, ...]) -> bool:
    return (path[-1] in _ACTIVATION_LEAVES
            and not any(p in path for p in _READ_IN_F32))


def _cast_tree(tree: Params, dtype: torch.dtype, path=()) -> Params:
    return {k: _cast_tree(v, dtype, (*path, k)) if isinstance(v, dict)
            else v.to(dtype) if _stored_as_activations((*path, k)) else v
            for k, v in tree.items()}


def model_init(seed: int, cfg: ArchConfig, run: RunConfig, *,
               device: torch.device | str = "cuda") -> tuple[Params, Specs]:
    """``(params, specs)``: random parameters drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default the
    card; a missing card raises), one layer at a time in f32, and the
    reference's logical-axis spec tree beside them (one tuple a leaf, a
    group's led by "layers"). The leaves only ever read as ``.to(x.dtype)``
    are stored in ``run.activations_dtype`` (an f32 run keeps every leaf
    f32); the rest stay f32. This changes storage, not the function: with
    bf16 activations the logits are bit-identical to those of the f32 run's
    tree from the same seed. On ``torch.device("meta")`` nothing is drawn
    or allocated: the tree's shapes, for counting parameters."""
    dev = (torch.device(device) if torch.device(device).type == "meta"
           else resolve_device(device))
    dtype = getattr(torch, run.activations_dtype)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    vp = padded_vocab(cfg, run)
    tokens = cfg.embed_input == "tokens"
    params: Params = {}
    specs: Specs = {}
    if tokens:
        p, specs["embed"] = embed_init(gen, vp, cfg.d_model, dev)
        params["embed"] = _cast_tree(p, dtype, ("embed",))
    for gi, (kind, count) in enumerate(cfg.layout):
        params[f"g{gi}"], specs[f"g{gi}"] = stack_init(
            lambda g: block_init(kind, g, cfg, dev), gen, count,
            lambda t: _cast_tree(t, dtype))
    params["final_norm"], specs["final_norm"] = norm_init(cfg.d_model, dev,
                                                          cfg.norm)
    if not (cfg.tie_embeddings and tokens):
        p, specs["lm_head"] = embed_init(gen, vp, cfg.d_model, dev)
        params["lm_head"] = _cast_tree(p, dtype, ("lm_head",))
    return params, specs


def abstract_init(cfg: ArchConfig, run: RunConfig) -> tuple[Params, Specs]:
    """``(params, specs)``: the parameter tree's shapes and dtypes on
    ``torch.device("meta")``, allocating nothing, and its spec tree (the
    reference's ``abstract_init``)."""
    return model_init(0, cfg, run, device="meta")


def _layer(gparams: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the group's stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in gparams.items()}


def _embed(params, cfg: ArchConfig, run: RunConfig, batch: dict,
           pos0: int = 0) -> torch.Tensor:
    dt = getattr(torch, run.activations_dtype)
    if cfg.embed_input == "tokens":
        x = embed_apply(params["embed"], batch["tokens"], dt,
                        padded_vocab(cfg, run))
    else:  # modality frontend stub: precomputed frame/patch embeddings
        x = batch["frames"].to(dt)
    if cfg.pos == "sinusoidal":
        S = x.shape[1]
        pos = pos0 + torch.arange(S, device=x.device)
        x = x + sinusoidal(pos, cfg.d_model).to(dt)
    return x


def _unbind(gparams: Params, count: int) -> list[Params]:
    """The group's layers as views, each stacked leaf unbound once."""
    parts = tree_map(lambda t: torch.unbind(t, 0), gparams)
    return [tree_map(lambda t: t[i], parts) for i in range(count)]


def _group_apply(kind: str, gparams: Params, count: int, x: torch.Tensor,
                 cfg: ArchConfig, run: RunConfig, positions: torch.Tensor):
    """The group's layers in order: (x, summed aux f32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unbind(gparams, count):
        if run.remat == "block":
            x, a = checkpoint(block_apply, kind, lp, x, cfg, run, positions,
                              use_reentrant=False)
        else:
            x, a = block_apply(kind, lp, x, cfg, run, positions)
        aux = aux + a
    return x, aux


def _logits(params, cfg: ArchConfig, x: torch.Tensor,
            lo: int = 0) -> torch.Tensor:
    """The f32 logits of the LM head's vocabulary rows from ``lo`` on (the
    rank's block under tensor parallelism), padded entries masked."""
    table = params["lm_head"] if "lm_head" in params else params["embed"]
    logits = lm_head_apply(table, x).float()
    vp = logits.shape[-1]
    if lo + vp > cfg.vocab:  # mask padded vocab entries
        mask = torch.arange(lo, lo + vp, device=x.device) < cfg.vocab
        logits = torch.where(mask, logits, -1e30)
    return logits


def _lse_and_label(params, cfg: ArchConfig, run: RunConfig,
                   x: torch.Tensor, labels: torch.Tensor):
    """``(logsumexp, the label's logit)`` of the f32 logits. Where tensor
    parallelism splits the (padded) vocabulary, from this rank's block of
    the LM head: the max, the sum of the exponentials and the label's
    logit reduced over the model ranks (as ``jax.nn.logsumexp``, the max
    carries no gradient). A whole vocabulary takes ``torch.logsumexp``,
    one fused reduction, and its backward."""
    tp = tensor_parallel().over(padded_vocab(cfg, run))
    lo, hi = tp.block(padded_vocab(cfg, run))
    logits = _logits(params, cfg, tp.enter(x), lo)
    if tp.m == 1:
        lse = torch.logsumexp(logits, dim=-1)
    else:
        mx = tp.max(logits.amax(-1))
        lse = mx + torch.log(tp.leave(torch.exp(logits - mx[..., None])
                                      .sum(-1)))
    inside = (labels >= lo) & (labels < hi)
    ll = torch.gather(logits, -1,
                      (labels - lo).clamp(0, hi - lo - 1)[..., None])[..., 0]
    return lse, tp.leave(torch.where(inside, ll, 0.0))


def forward(params: Params, batch: dict, cfg: ArchConfig, run: RunConfig):
    """Training forward: ``(loss, metrics)``. ``batch`` holds ``tokens``
    (B, S) (a frame model's ``frames`` (B, S, d)) and ``labels`` (B, S).
    The loss is the mean cross-entropy (from ``logsumexp`` of the f32
    logits) plus ``run.z_loss`` times the mean squared log-normaliser plus
    the MoE load-balance loss times its coefficient."""
    x = _embed(params, cfg, run, batch)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (kind, count) in enumerate(cfg.layout):
        x, aux = _group_apply(kind, params[f"g{gi}"], count, x, cfg, run,
                              positions)
        aux_total = aux_total + aux
    x = norm_apply(params["final_norm"], x)
    labels = batch["labels"].to(device=x.device, dtype=torch.long)
    lse, ll = _lse_and_label(params, cfg, run, x, labels)
    ce = (lse - ll).mean()
    zl = run.z_loss * (lse**2).mean()
    aux_coef = cfg.moe.aux_loss_coef if cfg.moe else 0.0
    loss = ce + zl + aux_coef * aux_total
    return loss, {"ce": ce, "z_loss": zl, "moe_aux": aux_total}


def loss_fn(params: Params, batch: dict, cfg: ArchConfig, run: RunConfig):
    return forward(params, batch, cfg, run)


def value_and_grad(fn, params: Params, *args):
    """``((value, aux), grads)`` of ``fn(params, *args) -> (value, aux)``,
    the gradients a tree like ``params`` (zeros for a leaf the value does
    not reach), as ``jax.value_and_grad(fn, has_aux=True)`` returns them.
    The leaves are differentiated through detached aliases, so that the
    caller may update ``params`` in place afterwards."""
    alias = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(alias)
    with torch.enable_grad():
        value, aux = fn(alias, *args)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(leaves, grads))
    return ((value.detach(), tree_map(lambda t: t.detach(), aux)),
            tree_map(lambda _: next(it), alias))


def make_train_step(cfg: ArchConfig, run: RunConfig, optimizer):
    """(state, batch) -> (state, metrics); ``optimizer`` has
    ``update(state, grads)`` (``repro_torch.train.optim``)."""

    def train_step(state, batch):
        (loss, metrics), grads = value_and_grad(
            lambda p: loss_fn(p, batch, cfg, run), state.params)
        state = optimizer.update(state, grads)
        return state, dict(metrics, loss=loss)

    return train_step


class _Serving:
    """Serving on the ranks of the ``shardctx`` mesh for a global batch of
    ``n`` rows (``set_ctx(..., blocks=True)``): the data axes that split
    the rows (``dist.sharding``'s rule for ``("batch", ...)``), this
    rank's rows of a whole batch, and the ``TensorParallel`` the layers
    read."""

    def __init__(self, mesh, n: int):
        from ..dist.comm import TensorParallel
        from ..dist.sharding import _flat_axes, mesh_coords, spec_for_shape

        self.mesh = mesh
        self.coords = mesh_coords(mesh)
        self.row_entry = spec_for_shape(("batch",), (n,), mesh)[0]
        self.tp = TensorParallel(mesh, _flat_axes(self.row_entry))

    def rows(self, batch: dict) -> dict:
        from ..dist.sharding import shard_slices

        out = dict(batch)
        for k, t in batch.items():
            if torch.is_tensor(t) and t.dim() >= 1:
                spec = (self.row_entry,) + (None,) * (t.dim() - 1)
                out[k] = t[shard_slices(spec, t.shape, self.mesh,
                                        self.coords)]
        return out

    def whole_logits(self, logits: torch.Tensor, vocab: int) -> torch.Tensor:
        """The rank's rows and vocabulary block of the logits gathered
        whole."""
        from ..dist.comm import gather_shards

        model = "model" if self.tp.split(vocab) else None
        return gather_shards(self.mesh, logits, (self.row_entry, None, model))


def _serving(n: int) -> _Serving | None:
    """The serving layout of a global batch of ``n`` rows, when the
    ``shardctx`` mesh was set with ``blocks=True``; else None."""
    from ..shardctx import _CTX, serving_blocks

    return _Serving(_CTX["mesh"], n) if serving_blocks() else None


@contextlib.contextmanager
def _served(batch: dict):
    """``(the batch this rank runs, its serving layout)``: on a mesh set
    with ``blocks=True`` its rows, inside ``shardctx.serving_on``; else
    ``(batch, None)``."""
    from ..shardctx import serving_on

    sv = _serving((batch["tokens"] if "tokens" in batch
                   else batch["frames"]).shape[0])
    if sv is None:
        yield batch, None
        return
    with serving_on(sv.tp):
        yield sv.rows(batch), sv


def _last_logits(params, cfg: ArchConfig, run: RunConfig, x: torch.Tensor,
                 sv: _Serving | None) -> torch.Tensor:
    """The f32 logits of ``x`` (B, 1, d), whole on every rank."""
    vp = padded_vocab(cfg, run)
    lo, _ = tensor_parallel().over(vp).block(vp)
    logits = _logits(params, cfg, x, lo)
    return sv.whole_logits(logits, vp) if sv else logits


@torch.no_grad()
def prefill(params: Params, batch: dict, cfg: ArchConfig, run: RunConfig,
            cache_len: int | None = None):
    """Run the prompt ``batch["tokens"]`` (B, S) (a frame model's
    ``batch["frames"]`` (B, S, d)); return (last-token logits (B, 1, V_pad)
    f32, caches). On a mesh: the rank's blocks (module docstring).

    ``cache_len`` pads non-ring caches to that capacity so decode can append.
    """
    with _served(batch) as (batch, sv):
        x = _embed(params, cfg, run, batch)
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        caches: dict[str, Any] = {}
        for gi, (kind, count) in enumerate(cfg.layout):
            caches[f"g{gi}"] = []
            for i in range(count):
                x, cache = block_prefill(kind, _layer(params[f"g{gi}"], i),
                                         x, cfg, run, positions,
                                         cache_len=cache_len)
                caches[f"g{gi}"].append(cache)
        x = norm_apply(params["final_norm"], x)
        return _last_logits(params, cfg, run, x[:, -1:, :], sv), caches


def init_caches(cfg: ArchConfig, run: RunConfig, batch: int, max_len: int,
                device: torch.device | str = "cuda"):
    """Zeroed decode caches, one dict per layer of every group; on a mesh
    this rank's ``CACHE_RULES`` blocks of them."""
    from ..dist.sharding import CACHE_RULES, shard_slices, spec_for_shape

    dev = resolve_device(device)
    sv = _serving(batch)
    out = {}
    for gi, (kind, count) in enumerate(cfg.layout):
        if sv is None:
            out[f"g{gi}"] = [block_init_cache(kind, cfg, run, batch, max_len,
                                              dev) for _ in range(count)]
            continue
        whole = block_init_cache(kind, cfg, run, batch, max_len,
                                 torch.device("meta"))

        def block(t, axes):
            spec = spec_for_shape(axes, t.shape, sv.mesh, CACHE_RULES)
            if "seq" in axes and sv.tp.model is not None:
                sv.tp.seq_block(t)  # a length the axis does not divide raises
            sl = shard_slices(spec, t.shape, sv.mesh, sv.coords)
            return torch.zeros(tuple(s.stop - s.start for s in sl),
                               dtype=t.dtype, device=dev)

        out[f"g{gi}"] = [tree_map(block, whole,
                                  _block_cache_axes(kind, cfg, run))
                         for _ in range(count)]
    return out


def _block_cache_axes(kind: str, cfg: ArchConfig, run: RunConfig):
    kv = {
        "k": ("batch", "seq", "kv_heads", "head_dim"),
        "v": ("batch", "seq", "kv_heads", "head_dim"),
    }
    if run.kv_cache_dtype == "int8":
        kv["k_scale"] = ("batch", "seq", "kv_heads", None)
        kv["v_scale"] = ("batch", "seq", "kv_heads", None)
    ssd = {
        "conv": ("batch", "conv", "mlp"),
        "state": ("batch", "heads", "state", "head_dim"),
    }
    if kind in ("attn_dense", "attn_moe"):
        return kv
    if kind in ("mla_dense", "mla_moe"):
        return {"ckv": ("batch", "seq", "kv_lora"),
                "krope": ("batch", "seq", "qk_rope")}
    if kind == "ssd":
        return ssd
    if kind in ("hymba_g", "hymba_w"):
        return {"attn": dict(kv), "ssm": dict(ssd)}
    raise ValueError(kind)


def cache_axes(cfg: ArchConfig, run: RunConfig):
    """Logical-axis tuples of the reference's stacked caches (a leading
    "layers" dim per group), the spec tree ``dist.sharding`` resolves."""
    out = {}
    for gi, (kind, _) in enumerate(cfg.layout):
        out[f"g{gi}"] = tree_map(lambda ax: ("layers", *ax),
                                 _block_cache_axes(kind, cfg, run))
    return out


@torch.no_grad()
def decode_step(params: Params, caches: dict, batch: dict, cfg: ArchConfig,
                run: RunConfig):
    """One decode step against the caches: ``batch`` holds ``tokens``
    (B, 1) (a frame model's ``frames`` (B, 1, d)) and ``pos``, the tokens
    already cached. Returns (logits (B, 1, V_pad), caches), the caches
    updated. On a mesh: the rank's blocks (module docstring)."""
    pos = int(batch["pos"])
    with _served(batch) as (batch, sv):
        x = _embed(params, cfg, run, batch, pos0=pos)
        for gi, (kind, count) in enumerate(cfg.layout):
            group = caches[f"g{gi}"]
            for i in range(count):
                x, group[i] = block_decode(kind, _layer(params[f"g{gi}"], i),
                                           group[i], x, cfg, run, pos)
        x = norm_apply(params["final_norm"], x)
        return _last_logits(params, cfg, run, x, sv), caches
