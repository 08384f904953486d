"""Model assembly: ArchConfig -> init / train / prefill / decode.

`Model` is an ``nn.Module`` whose top-level names are the reference's
parameter tree: ``embed``, ``final_norm``, ``lm_head`` and the family's
layer stacks as ``nn.ModuleList``s of blocks (``layers``; ``dense0`` for
DeepSeek-V2's leading dense layer; ``swa``/``global`` for Hymba;
``self`` as (groups, per) nested lists and ``cross`` for the VLM;
``encoder``, ``enc_norm``, ``frontend_proj`` for whisper).  Where the
reference scans stacked (L, ...) parameters, the port loops over the
list; caches stay stacked tensors, e.g. (L, B, S, KVH, hd), and each layer
writes its slice in place.

Training: parameters are created with ``requires_grad=False``, so that no
serving path builds an autograd graph; the train step
(`repro_torch.launch.steps.make_train_step`) turns gradients on for the
model it trains.  ``remat=True`` recomputes each layer's activations in
the backward pass (``torch.utils.checkpoint``, non-reentrant) wherever the
reference wraps its layer scan in ``jax.checkpoint``: the decoder, SSM,
Hymba SWA, VLM self-attention and whisper encoder stacks.  It changes
memory, never values.  The config's ``remat_policy`` says what the
recomputation keeps: ``"full"`` keeps nothing, so on a mesh of ranks
it issues the layer's collectives again; ``"save_collectives"`` keeps
the outputs of the collectives inside the layer (the reference's
``tp_collective_out`` points: the row-parallel attention and MLP
outputs, the expert-parallel MoE's sums; `remat.KeptCollectives`) and
gives them back, so the recomputation issues none of them and skips the
row-parallel products that made them.  Early stop
(``torch.utils.checkpoint.set_checkpoint_early_stop``, on by default)
ends a recomputation at the last tensor the backward needs, so
``"full"`` issues again only the collectives before it: a dense layer's
two row-parallel sums (the MLP's product saves its operands once it
has summed), a MoE layer's attention sum.  A model that holds its
leaves whole issues no collective and keeps nothing: the two policies
recompute the same.

A rank of a mesh of ranks: ``Model(cfg, device, shard)`` with
``shard = ParamShard.of(mesh)`` (the mesh's shape and the rank's
coordinate) holds, of each leaf, the block that the reference's planner
gives that position (`repro_torch.sharding.ParamShard.block`: its
``plan_params`` spec, then `shard_slices`), in every family, and
``forward(..., mesh_info=(mesh, batch_axes))`` on that mesh issues the
collectives that XLA inserts for those specs: the vocab-parallel
embedding (`layers.embed_tokens`: one ``all_reduce``), head-parallel
attention (GQA, MLA, cross and encoder attention) and ffn-parallel MLPs
(one ``all_reduce`` each, `blocks`), the Mamba-2 mixer over its inner
dim (`mamba2`), expert-parallel MoE (`moe.moe_ffn_sharded`), the
column-parallel frontend projection and the vocab-parallel head (each a
block ``all_gather``ed over ``model``; its input passes ``copy_to``,
whose backward sums over ``model``).  Each has the backward a loss
replicated over ``model`` needs (`repro_torch.launch.mesh`), so a rank
trains its blocks.  ``blocks`` maps each parameter held as a block to
(its whole shape, the block).  A rank's model comes from a seed
(`build_model`; each block is the unsharded model's, bit for bit) or from
the reference's weights (`repro_torch.interop.rank_model_from`).

Its decode caches (`Model.init_caches`, a `Caches`) hold the block of
every cache leaf that ``plan_caches`` gives the position
(`ParamShard.cache_blocks`): the KV heads, or a block of the sequence
slots (where the KV heads do not divide the model axis, or the batch
does not divide the batch axes, which then join the split), the MLA
latents' sequence block, the SSM state's heads and the conv tail's
channels.  The forward reads each group's sequence block
(`attention.SeqBlock`) from the caches' ``blocks`` and passes it to the
layers that write and attend over it.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.sharding.planner import ParamShard

from .attention import SeqBlock, init_kv_cache
from .blocks import (CrossBlock, DenseBlock, EncDecBlock, EncoderBlock,
                     HybridBlock, MoEBlock, SSMBlock, _param, cross_kv,
                     init_block_cache, write_kv)
from .config import ArchConfig
from .init import init_params
from .layers import DTYPES, cross_entropy_loss, embed_tokens, rms_norm
from .remat import KeptCollectives

__all__ = ["Model", "Caches", "build_model", "init_params", "reference_path"]


class Caches(dict):
    """A decode-cache tree (nested dicts of tensors, as the reference
    stacks them) with ``blocks``: each leaf's key path -> (its
    ``plan_caches`` spec, its whole shape, the block this rank holds)."""

    def __init__(self, tree: dict, blocks: dict):
        super().__init__(tree)
        self.blocks = blocks

    def seq(self, *keys) -> SeqBlock | None:
        """The sequence block of the group at ``keys`` (a {k, v, pos} or
        {c_kv, k_pe, pos} group): None where this rank holds all of its
        slots."""
        spec, whole, block = self.blocks[keys + ("pos",)]
        entry = spec[-1] if len(spec) == len(whole) else None
        if entry is None:
            return None
        axes = entry if isinstance(entry, tuple) else (entry,)
        return SeqBlock(axes, block[-1].start, whole[-1])


def _seq(caches, *keys) -> SeqBlock | None:
    return caches.seq(*keys) if isinstance(caches, Caches) else None


def _cut_caches(node, cut: dict, blocks: dict, device, keys=()):
    """The zeroed blocks (``cut``: key path -> (spec, block)) of a whole
    meta cache tree on ``device``, positions at -1 (empty slots); each
    leaf's (spec, whole shape, block) recorded in ``blocks``.  A module
    function: a recursive closure over the model would keep the model
    alive, a reference cycle, until the next garbage collection."""
    if isinstance(node, dict):
        return {k: _cut_caches(v, cut, blocks, device, keys + (k,))
                for k, v in node.items()}
    spec, block = cut[keys]
    blocks[keys] = (spec, tuple(node.shape), block)
    shape = tuple(len(range(n)[b]) for n, b in zip(node.shape, block))
    if node.dtype == torch.int32:
        return torch.full(shape, -1, dtype=node.dtype, device=device)
    return torch.zeros(shape, dtype=node.dtype, device=device)


def reference_path(name: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """A `Model` parameter name -> (the reference tree's keys, the index
    into that leaf's stack dims): ``"layers.3.attn.wq"`` ->
    ``(("layers", "attn", "wq"), (3,))``, ``"self.0.1.mlp.w_up"`` ->
    ``(("self", "mlp", "w_up"), (0, 1))``, ``"embed"`` -> ``(("embed",), ())``."""
    parts = name.split(".")
    keys = tuple(p for p in parts if not p.isdigit())
    index = tuple(int(p) for p in parts if p.isdigit())
    return keys, index


def _index(tree, *idx):
    """The views of one layer in a stacked cache dict (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, *idx) for k, v in tree.items()}
    return tree[idx]


def _stack(n: int, make) -> nn.ModuleList:
    return nn.ModuleList([make() for _ in range(n)])


REMAT_POLICIES = ("full", "save_collectives")


def _layer(blk: nn.Module, remat: bool, *args, **kw):
    """``blk(*args, **kw)``; with ``remat``, its activations are recomputed
    in the backward pass instead of kept, but for what its config's
    ``remat_policy`` keeps (see the module docstring)."""
    if not remat:
        return blk(*args, **kw)
    policy = blk.cfg.remat_policy
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} is not one of {REMAT_POLICIES}")
    fn = KeptCollectives().run if policy == "save_collectives" else None
    if fn is None:
        return checkpoint(blk, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return checkpoint(fn, blk, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


class Model(nn.Module):
    """One architecture config's model; parameters are created
    uninitialized on ``device`` (``"meta"`` gives shapes only) and filled
    by `init`."""

    def __init__(self, cfg: ArchConfig, device: "str | torch.device" = "cuda",
                 shard: ParamShard | None = None):
        super().__init__()
        self.cfg = cfg
        self.shard = shard or ParamShard()
        target = (torch.device("meta") if str(device) == "meta"
                  else resolve_device(device))
        self._build(cfg, DTYPES[cfg.param_dtype], torch.device("meta"))
        # Cut each leaf to this position's block while no memory is held.
        self.blocks: dict[str, tuple[tuple[int, ...], tuple[slice, ...]]] = {}
        for name, param in list(self.named_parameters()):
            whole = tuple(param.shape)
            block = self.leaf_block(reference_path(name)[0], whole)
            local = tuple(len(range(n)[b]) for n, b in zip(whole, block))
            if local != whole:
                self.blocks[name] = (whole, block)
                path, _, leaf = name.rpartition(".")
                setattr(self.get_submodule(path), leaf,
                        _param(local, param.dtype, param.device))
        if target.type != "meta":
            self.to_empty(device=target)

    def leaf_block(self, keys, shape) -> tuple[slice, ...]:
        """The block of the reference tree's leaf at ``keys`` with
        ``shape`` (one layer's, or stacked: the rules count dimensions
        from the end) that this model holds: the planner's block for its
        position (`ParamShard.block`)."""
        return self.shard.block(keys, shape)[1]

    def _build(self, cfg: ArchConfig, dt, dev) -> None:
        d = cfg.d_model
        self.embed = _param((cfg.vocab_size, d), dt, dev)
        self.final_norm = _param((d,), dt, dev)
        self.lm_head = _param((d, cfg.vocab_size), dt, dev)
        fam = cfg.family
        if fam == "dense":
            self.layers = _stack(cfg.num_layers, lambda: DenseBlock(cfg, dt, dev))
        elif fam == "moe":
            self.layers = _stack(cfg.num_layers - cfg.first_dense_layers,
                                 lambda: MoEBlock(cfg, dt, dev))
            if cfg.first_dense_layers:
                self.dense0 = _stack(cfg.first_dense_layers,
                                     lambda: DenseBlock(cfg, dt, dev))
        elif fam == "ssm":
            self.layers = _stack(cfg.num_layers, lambda: SSMBlock(cfg, dt, dev))
        elif fam == "hybrid":
            n_glob = len(cfg.global_attn_layers)
            self.swa = _stack(cfg.num_layers - n_glob, lambda: HybridBlock(cfg, dt, dev))
            self.add_module("global", _stack(n_glob, lambda: HybridBlock(cfg, dt, dev)))
        elif fam == "vlm":
            n_cross = cfg.num_layers // (cfg.cross_attn_every + 1)
            per = cfg.cross_attn_every
            groups = (cfg.num_layers - n_cross) // per
            assert groups == n_cross, (cfg.num_layers, n_cross, per)
            self.add_module("self", _stack(
                groups, lambda: _stack(per, lambda: DenseBlock(cfg, dt, dev))))
            self.cross = _stack(groups, lambda: CrossBlock(cfg, dt, dev))
        elif fam == "audio":
            self.encoder = _stack(cfg.encoder_layers, lambda: EncoderBlock(cfg, dt, dev))
            self.enc_norm = _param((d,), dt, dev)
            self.layers = _stack(cfg.num_layers, lambda: EncDecBlock(cfg, dt, dev))
            if cfg.frontend_dim and cfg.frontend_dim != d:
                self.frontend_proj = _param((cfg.frontend_dim, d), dt, dev)
        else:
            raise ValueError(f"unknown family {fam!r}")

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator) -> "Model":
        """Fill the parameters from ``generator`` (see `init_params`)."""
        return init_params(self, generator)

    def reference_leaves(self) -> dict:
        """The reference tree's leaf keys -> ``(stacked shape,
        [(stack index, parameter), ...])``, in parameter order."""
        groups: dict = {}
        for name, param in self.named_parameters():
            keys, index = reference_path(name)
            groups.setdefault(keys, []).append((index, param))
        out = {}
        for keys, items in groups.items():
            lead = tuple(max(col) + 1 for col in zip(*(i for i, _ in items)))
            out[keys] = (lead + tuple(items[0][1].shape), items)
        return out

    def param_shapes(self) -> dict:
        """The reference's ``init_params`` tree with each leaf's stacked
        shape (what `repro_torch.sharding.plan_params` reads)."""
        tree: dict = {}
        for keys, (shape, _) in self.reference_leaves().items():
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = shape
        return tree

    # ------------------------------------------------------------- caches
    def _whole_caches(self, batch: int, cache_len: int, dev) -> dict:
        """The unsharded model's zeroed caches on ``dev``."""
        cfg = self.cfg
        dt = DTYPES[cfg.activation_dtype]
        fam = cfg.family

        def block(kind, lead, window_len=None):
            return init_block_cache(cfg, kind, batch, cache_len, dt, dev,
                                    window_len, lead)

        def cross(lead):  # cross K/V over the frontend's positions
            return init_kv_cache(batch, cfg.frontend_seq, cfg.num_kv_heads,
                                 cfg.head_dim, dt, dev, lead)

        if fam in ("dense", "moe"):
            kind = "mla" if cfg.use_mla else "attn"
            caches = {"layers": block(kind, (cfg.num_layers - cfg.first_dense_layers,))}
            if cfg.first_dense_layers:
                caches["dense0"] = block(kind, (cfg.first_dense_layers,))
            return caches
        if fam == "ssm":
            return {"layers": block("ssm", (cfg.num_layers,))}
        if fam == "hybrid":
            n_glob = len(cfg.global_attn_layers)
            return {"swa": block("hybrid", (cfg.num_layers - n_glob,),
                                 window_len=min(cfg.sliding_window, cache_len)),
                    "global": block("hybrid", (n_glob,))}
        if fam == "vlm":
            per = cfg.cross_attn_every
            groups = cfg.num_layers // (per + 1)
            return {"self": block("attn", (groups, per)), "cross_kv": cross((groups,))}
        if fam == "audio":
            return {"layers": block("attn", (cfg.num_layers,)),
                    "cross": cross((cfg.num_layers,))}
        raise ValueError(fam)

    def init_caches(self, batch: int, cache_len: int,
                    seq_parallel_decode: bool = True) -> Caches:
        """Zeroed decode caches of a ``batch`` (the whole batch, on a mesh
        of ranks too) on the model's device, stacked per layer stack as
        the reference stacks them (empty slots at position -1): on a rank,
        the block of each leaf that ``plan_caches`` gives its position
        (`ParamShard.cache_blocks`; ``seq_parallel_decode`` as the
        planner's), recorded in the result's ``blocks``."""
        whole = self._whole_caches(batch, cache_len, torch.device("meta"))
        cut = self.shard.cache_blocks(whole, seq_parallel_decode)
        blocks: dict = {}
        return Caches(_cut_caches(whole, cut, blocks, self.device), blocks)

    # ------------------------------------------------------------ forward
    def forward(
        self,
        tokens: torch.Tensor,  # (B, S)
        *,
        mode: str = "train",
        caches: Any = None,
        positions: torch.Tensor | None = None,
        frontend: torch.Tensor | None = None,  # (B, Sf, Df) stub embeddings
        mesh_info=None,
        remat: bool = False,
        kv_chunk: int = 1024,
    ):
        """Returns (logits, caches, aux_loss); prefill and decode write
        ``caches`` in place and return it.  ``frontend`` is cast to the
        activation dtype (its cross K/V are cached in it).  ``mesh_info``:
        ``(mesh, batch_axes)`` on a mesh of ranks (the position this
        model's ``shard`` is, where it holds blocks of its leaves; see the
        module docstring).  ``remat``: see the module
        docstring."""
        cfg = self.cfg
        mesh = self._rank_mesh(mesh_info)
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device).expand(b, s)
        if frontend is not None:
            frontend = frontend.to(DTYPES[cfg.activation_dtype])
        x = embed_tokens(self.embed, tokens, cfg.vocab_size, mesh)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        fam = cfg.family
        if fam in ("dense", "moe"):
            x, aux = self._fwd_decoder(x, positions, mode, caches, kv_chunk, aux,
                                       remat, mesh_info)
        elif fam == "ssm":
            lc = caches["layers"] if caches is not None else None
            for i, blk in enumerate(self.layers):
                x = _layer(blk, remat, x, positions, mode, _index(lc, i),
                           mesh_info=mesh_info)
        elif fam == "hybrid":
            x = self._fwd_hybrid(x, positions, mode, caches, kv_chunk, remat,
                                 mesh_info)
        elif fam == "vlm":
            x = self._fwd_vlm(x, positions, mode, caches, frontend, kv_chunk,
                              remat, mesh_info)
        elif fam == "audio":
            x = self._fwd_audio(x, positions, mode, caches, frontend, kv_chunk,
                                remat, mesh_info)
        else:
            raise ValueError(fam)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        if self.lm_head.shape[1] != cfg.vocab_size:  # this rank's vocab block
            logits = mesh.copy_to(x) @ self.lm_head
            logits = mesh.all_gather(logits, "model").movedim(0, -2).flatten(-2)
        else:
            logits = x @ self.lm_head
        return logits, caches, aux

    def _rank_mesh(self, mesh_info):
        """The rank mesh of ``mesh_info`` (None without one), checked
        against this model: a model holding blocks runs on the mesh whose
        position it holds."""
        mesh = mesh_info[0] if mesh_info is not None else None
        if self.blocks and (mesh is None or not self.shard.at(mesh)):
            raise ValueError(f"this model holds the blocks of {self.shard}; it "
                             "runs on that position of its mesh of ranks "
                             "(mesh_info)")
        return mesh

    # ------------------------------------------------- family sub-forwards
    def _fwd_decoder(self, x, positions, mode, caches, kv_chunk, aux, remat,
                     mesh_info):
        cfg = self.cfg
        if cfg.first_dense_layers:
            d0 = caches["dense0"] if caches is not None else None
            seq = _seq(caches, "dense0")
            for i, blk in enumerate(self.dense0):
                x = blk(x, positions, mode, _index(d0, i), kv_chunk=kv_chunk,
                        mesh_info=mesh_info, seq=seq)
        lc = caches["layers"] if caches is not None else None
        seq = _seq(caches, "layers")
        for i, blk in enumerate(self.layers):
            if cfg.is_moe:
                x, a = _layer(blk, remat, x, positions, mode, _index(lc, i),
                              kv_chunk, mesh_info=mesh_info, seq=seq)
                aux = aux + a
            else:
                x = _layer(blk, remat, x, positions, mode, _index(lc, i),
                           window=cfg.sliding_window, kv_chunk=kv_chunk,
                           mesh_info=mesh_info, seq=seq)
        return x, aux

    def _fwd_hybrid(self, x, positions, mode, caches, kv_chunk, remat,
                    mesh_info):
        """Hymba: SWA layers with the global-attention layers at their
        indices, in layer order (the reference's segment schedule)."""
        cfg = self.cfg
        glob = sorted(cfg.global_attn_layers)
        swa_c = caches["swa"] if caches is not None else None
        glob_c = caches["global"] if caches is not None else None
        swa_seq, glob_seq = _seq(caches, "swa", "attn"), _seq(caches, "global", "attn")
        swa_idx = 0
        for layer in range(cfg.num_layers):
            if layer in glob:
                gi = glob.index(layer)
                x = getattr(self, "global")[gi](x, positions, mode,
                                                _index(glob_c, gi), window=None,
                                                kv_chunk=kv_chunk,
                                                mesh_info=mesh_info, seq=glob_seq)
            else:
                x = _layer(self.swa[swa_idx], remat, x, positions, mode,
                           _index(swa_c, swa_idx), window=cfg.sliding_window,
                           kv_chunk=kv_chunk, mesh_info=mesh_info, seq=swa_seq)
                swa_idx += 1
        return x

    def _fwd_vlm(self, x, positions, mode, caches, frontend, kv_chunk, remat,
                 mesh_info):
        mesh = mesh_info[0] if mesh_info is not None else None
        self_c = caches["self"] if caches is not None else None
        ckv = caches["cross_kv"] if caches is not None else None
        seq, cross_seq = _seq(caches, "self"), _seq(caches, "cross_kv")
        for g, (group, cross) in enumerate(zip(getattr(self, "self"), self.cross)):
            for j, blk in enumerate(group):
                x = _layer(blk, remat, x, positions, mode, _index(self_c, g, j),
                           kv_chunk=kv_chunk, mesh_info=mesh_info, seq=seq)
            if mode == "decode":
                enc_kv = _index(ckv, g)
            else:
                enc_kv = cross_kv(cross.attn, frontend, self.cfg, mesh)
                if mode == "prefill":  # only a decode cache keeps cross K/V
                    write_kv(_index(ckv, g), enc_kv["k"], enc_kv["v"], enc_kv["pos"],
                             mesh, cross_seq)
            x = cross(x, enc_kv, mode, mesh_info=mesh_info, seq=cross_seq)
        return x

    def _fwd_audio(self, x, positions, mode, caches, frontend, kv_chunk, remat,
                   mesh_info):
        cfg = self.cfg
        mesh = mesh_info[0] if mesh_info is not None else None
        if mode != "decode":  # at decode cross K/V comes from the cache
            enc = frontend
            if hasattr(self, "frontend_proj"):
                if self.frontend_proj.shape[1] != cfg.d_model:  # column block
                    enc = mesh.copy_to(enc) @ self.frontend_proj
                    enc = mesh.all_gather(enc, "model").movedim(0, -2).flatten(-2)
                else:
                    enc = enc @ self.frontend_proj
            b, se = enc.shape[:2]
            enc_pos = torch.arange(se, dtype=torch.int32, device=enc.device).expand(b, se)
            for blk in self.encoder:
                enc = _layer(blk, remat, enc, enc_pos, kv_chunk,
                             mesh_info=mesh_info)
            enc_states = rms_norm(enc, self.enc_norm, cfg.norm_eps)
        lc = caches["layers"] if caches is not None else None
        ckv = caches["cross"] if caches is not None else None
        seq, cross_seq = _seq(caches, "layers"), _seq(caches, "cross")
        for i, blk in enumerate(self.layers):
            if mode == "decode":
                enc_kv = _index(ckv, i)
            else:
                enc_kv = cross_kv(blk.cross_attn, enc_states, cfg, mesh)
                if mode == "prefill":
                    write_kv(_index(ckv, i), enc_kv["k"], enc_kv["v"], enc_kv["pos"],
                             mesh, cross_seq)
            x = blk(x, positions, enc_kv, mode, _index(lc, i), kv_chunk,
                    mesh_info=mesh_info, seq=seq, cross_seq=cross_seq)
        return x

    # --------------------------------------------------------------- loss
    def loss(self, batch: dict, *, mesh_info=None, remat: bool = False,
             kv_chunk: int = 1024, aux_weight: float = 0.01):
        """(ce + aux_weight * aux, {"ce", "aux"}) of a batch of tensors on
        the model's device (``tokens``; ``labels`` and ``frontend`` where
        given); ``mesh_info`` as in `forward`."""
        logits, _, aux = self.forward(batch["tokens"], mode="train",
                                      frontend=batch.get("frontend"),
                                      mesh_info=mesh_info, remat=remat,
                                      kv_chunk=kv_chunk)
        if "labels" in batch:
            ce = cross_entropy_loss(logits, batch["labels"])
        else:  # next-token prediction: shift by one
            ce = cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:])
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def build_model(cfg: ArchConfig, device: "str | torch.device" = "cuda",
                seed: int | None = None,
                shard: ParamShard | None = None) -> Model:
    """``Model(cfg, device, shard)``; with ``seed``, initialized from a
    ``torch.Generator`` on that device seeded with it (a rank's blocks
    are the unsharded model's blocks, bit for bit)."""
    model = Model(cfg, device, shard)
    if seed is not None:
        model.init(torch.Generator(device=model.device).manual_seed(seed))
    return model
