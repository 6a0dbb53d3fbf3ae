"""Decoder LM for serving: embed -> block groups -> norm -> LM head. Twin of
the serving half of ``repro.models.model``.

Parameters keep the reference's tree: ``embed`` (token models only), one
``g{i}`` per layout group with every leaf stacked on a leading "layers"
dim, ``final_norm`` and ``lm_head`` (untied, or a frame model's). A frame
model (``embed_input="frames"``) reads precomputed embeddings
``batch["frames"]`` (B, S, d) in place of ``batch["tokens"]``.
``model_init`` draws the parameters in f32, one layer at a time, and
stores the leaves that are only ever cast to the activations' dtype in
``run.activations_dtype``, which a model too large for the card in f32
needs. The reference scans each group with ``lax.scan``; the
port loops over the layers and indexes the stacked weights. ``remat`` and
sharding constraints have no meaning when serving on one card. Caches are
per layer: ``caches["g{i}"]`` is a list with one dict per layer of the
group (the reference stacks them); decode writes KV caches in place.

``forward``/``loss_fn`` and training come with the training slice.
"""
from __future__ import annotations

from typing import Any

import torch

from ..device import resolve_device
from .blocks import block_apply, block_decode, block_init, block_init_cache
from .config import ArchConfig, RunConfig
from .layers import (
    Params, embed_apply, embed_init, lm_head_apply, norm_apply, norm_init,
)
from .rope import sinusoidal


def check_run(run: RunConfig) -> None:
    """Raise on the RunConfig options the port does not implement."""
    if run.attn_stream_bf16 or run.ssd_stream_bf16:
        raise NotImplementedError(
            "attn_stream_bf16 / ssd_stream_bf16: the port's kernels compute "
            "in f32 from their inputs' dtype; no configuration sets them"
        )


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


def _stack_init(init_fn, count: int, dtype: torch.dtype) -> Params:
    """``count`` layers of ``init_fn()`` stacked on a leading dim, drawn one
    layer at a time in f32 and stored by ``_cast_tree`` in ``dtype``: the
    peak is the stack plus one layer's f32 draws."""
    layer = _cast_tree(init_fn(), dtype)
    stack = _map(lambda t: t.new_empty((count, *t.shape)), layer)
    _copy_into(stack, layer, 0)
    del layer
    for i in range(1, count):
        _copy_into(stack, init_fn(), i)
    return stack


def _map(fn, tree: Params) -> Params:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _copy_into(stack: Params, layer: Params, i: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_into(stack[k], v, i)
        elif v.device.type != "meta":
            stack[k][i].copy_(v)


def model_init(seed: int, cfg: ArchConfig, run: RunConfig, *,
               device: torch.device | str = "cuda") -> Params:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (default the card; a missing card raises), one
    layer at a time in f32. The leaves only ever read as ``.to(x.dtype)``
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
    if tokens:
        params.update(_cast_tree(
            {"embed": embed_init(gen, vp, cfg.d_model, dev)}, dtype))
    for gi, (kind, count) in enumerate(cfg.layout):
        params[f"g{gi}"] = _stack_init(
            lambda: block_init(kind, gen, cfg, dev), count, dtype)
    params["final_norm"] = norm_init(cfg.d_model, dev, cfg.norm)
    if not (cfg.tie_embeddings and tokens):
        params.update(_cast_tree(
            {"lm_head": embed_init(gen, vp, cfg.d_model, dev)}, dtype))
    return params


def _layer(gparams: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the group's stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in gparams.items()}


def _embed(params, cfg: ArchConfig, run: RunConfig, batch: dict,
           pos0: int = 0) -> torch.Tensor:
    dt = getattr(torch, run.activations_dtype)
    if cfg.embed_input == "tokens":
        x = embed_apply(params["embed"], batch["tokens"], dt)
    else:  # modality frontend stub: precomputed frame/patch embeddings
        x = batch["frames"].to(dt)
    if cfg.pos == "sinusoidal":
        S = x.shape[1]
        pos = pos0 + torch.arange(S, device=x.device)
        x = x + sinusoidal(pos, cfg.d_model).to(dt)
    return x


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    table = params["lm_head"] if "lm_head" in params else params["embed"]
    logits = lm_head_apply(table, x).float()
    vp = logits.shape[-1]
    if vp != cfg.vocab:  # mask padded vocab entries
        mask = torch.arange(vp, device=x.device) < cfg.vocab
        logits = torch.where(mask, logits, -1e30)
    return logits


@torch.no_grad()
def prefill(params: Params, batch: dict, cfg: ArchConfig, run: RunConfig,
            cache_len: int | None = None):
    """Run the prompt ``batch["tokens"]`` (B, S) (a frame model's
    ``batch["frames"]`` (B, S, d)); return (last-token logits (B, 1, V_pad)
    f32, caches).

    ``cache_len`` pads non-ring caches to that capacity so decode can append.
    """
    check_run(run)
    x = _embed(params, cfg, run, batch)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    caches: dict[str, Any] = {}
    for gi, (kind, count) in enumerate(cfg.layout):
        caches[f"g{gi}"] = []
        for i in range(count):
            x, cache = block_apply(kind, _layer(params[f"g{gi}"], i), x, cfg,
                                   run, positions, cache_len=cache_len)
            caches[f"g{gi}"].append(cache)
    x = norm_apply(params["final_norm"], x)
    return _logits(params, cfg, x[:, -1:, :]), caches


def init_caches(cfg: ArchConfig, run: RunConfig, batch: int, max_len: int,
                device: torch.device | str = "cuda"):
    """Zeroed decode caches, one dict per layer of every group."""
    check_run(run)
    dev = resolve_device(device)
    return {
        f"g{gi}": [block_init_cache(kind, cfg, run, batch, max_len, dev)
                   for _ in range(count)]
        for gi, (kind, count) in enumerate(cfg.layout)
    }


@torch.no_grad()
def decode_step(params: Params, caches: dict, batch: dict, cfg: ArchConfig,
                run: RunConfig):
    """One decode step against the caches: ``batch`` holds ``tokens``
    (B, 1) (a frame model's ``frames`` (B, 1, d)) and ``pos``, the tokens
    already cached. Returns (logits (B, 1, V_pad), caches), the caches
    updated."""
    check_run(run)
    pos = int(batch["pos"])
    x = _embed(params, cfg, run, batch, pos0=pos)
    for gi, (kind, count) in enumerate(cfg.layout):
        group = caches[f"g{gi}"]
        for i in range(count):
            x, group[i] = block_decode(kind, _layer(params[f"g{gi}"], i),
                                       group[i], x, cfg, run, pos)
    x = norm_apply(params["final_norm"], x)
    return _logits(params, cfg, x), caches
