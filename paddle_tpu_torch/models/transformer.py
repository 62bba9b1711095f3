"""Decoder-only Transformer LM — the counterpart of
``paddle_tpu/models/transformer.py`` for the serving and training paths.

Pre-LN blocks, one fused qkv matmul per block, attention as [B, T, H, Dh]
through :func:`ops.cuda_kernels.flash_attention` (causal; differentiable
through the flash backward kernels), learned position embeddings, and a
head tied to the token embedding. ``forward``, ``loss`` and
``shifted_loss`` are the training entries (``model.call(params, ids,
method="loss")`` is what ``Trainer`` differentiates); the decode methods
(``prefill``, ``decode_step``, ``decode_step_paged``, ``verify_step``,
``generate_fused`` and its alias ``generate_cached``) run without
autograd and write their caches in place; ``generate_fused`` runs each
step as one CUDA graph on the card (``core/graphs.py``).
``tie_head=False`` gives the model its own ``head`` [d_model, vocab] (no
bias), which the training forward and every decode method use;
``remat=True`` recomputes each block's activations in the backward
(:func:`_remat_block`, ``torch.utils.checkpoint``), as JAX wraps each
block in ``jax.checkpoint``. Not ported: ``prefill_paged`` (the prefix
cache) and sequence sharding (``positions``, ``seq_axis``). The model
carries its own parameters (JAX passes a parameter tree beside it); they
keep the JAX names and layouts so a JAX tree loads through
``paddle_tpu_torch.convert.params_from_numpy``.

The q/k/v, MLP and head matmuls stay ``torch.matmul``, as the JAX package
leaves them to XLA; only attention goes through the port's kernels.
Every attention entry takes ``route`` (None: the kernel for CUDA tensors,
the plain version for CPU ones; "plain": the plain version anywhere).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..nn import Embedding, LayerNorm, Linear, Module
from ..nn.initializer import normal
from ..ops import cuda_kernels as ck

Cell = Dict[str, torch.Tensor]


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean of lse - gold over f32 logits [..., V]: the per-token
    cross-entropy of the JAX models, averaged over ``mask`` (all ones when
    None) with the denominator held at >= 1."""
    l32 = logits.float()
    nll = torch.logsumexp(l32, dim=-1) - torch.gather(
        l32, -1, targets.long()[..., None])[..., 0]
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 init_std: float = 0.02, causal: bool = True):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_heads {n_heads}")
        self.n_heads = n_heads
        self.d_head = d_model // n_heads
        self.causal = causal
        self.ln1 = LayerNorm(d_model)
        self.qkv = Linear(d_model, 3 * d_model, w_init=normal(0.0, init_std))
        self.proj = Linear(d_model, d_model, w_init=normal(0.0, init_std))
        self.ln2 = LayerNorm(d_model)
        self.mlp_in = Linear(d_model, d_ff, act="gelu",
                             w_init=normal(0.0, init_std))
        self.mlp_out = Linear(d_ff, d_model, w_init=normal(0.0, init_std))

    def attend(self, q, k, v, *, kv_lens: Optional[torch.Tensor] = None,
               route: Optional[str] = None):
        return ck.flash_attention(q, k, v, causal=self.causal,
                                  kv_lens=kv_lens, route=route)

    def heads(self, x: torch.Tensor):
        """q, k, v as [B, T, H, Dh] views of one fused qkv matmul (no copy:
        the attention kernels read them through their strides)."""
        qkv = self.qkv(self.ln1(x))
        q, k, v = qkv.chunk(3, dim=-1)
        shape = (self.n_heads, self.d_head)
        return q.unflatten(-1, shape), k.unflatten(-1, shape), \
            v.unflatten(-1, shape)

    def finish(self, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """Residual + projection + MLP after attention output ``o``."""
        B, T, D = x.shape
        x = x + self.proj(o.reshape(B, T, D).to(x.dtype))
        return x + self.mlp_out(self.mlp_in(self.ln2(x)))

    def forward(self, x, *, kv_lens: Optional[torch.Tensor] = None,
                route: Optional[str] = None):
        q, k, v = self.heads(x)
        return self.finish(x, self.attend(q, k, v, kv_lens=kv_lens,
                                          route=route))


def _remat_block(blk: TransformerBlock, x: torch.Tensor,
                 route: Optional[str]) -> torch.Tensor:
    """``blk(x)`` whose activations are recomputed in the backward
    (``jax.checkpoint`` of the block). The block's parameters go in as
    inputs and the recompute runs the block on those same tensors, not
    on what its attributes hold by then: under ``Module.call`` (the
    trainer's tree) they are the tree's leaves only while the forward
    runs. ``preserve_rng_state=False``: the block draws no random number
    (the LM has no dropout), and saving or restoring the RNG state has no
    place inside a CUDA graph capture. The recompute sees the same
    inputs, so the gradients are those of the plain forward, bit for bit;
    on the card it launches the attention forward (#1) a second time a
    block."""
    names = [n for n, _ in blk.named_parameters()]
    leaves = [p for _, p in blk.named_parameters()]

    def run(x, *leaves):
        return torch.func.functional_call(blk, dict(zip(names, leaves)),
                                          (x,), {"route": route})

    return checkpoint(run, x, *leaves, use_reentrant=False,
                      preserve_rng_state=False)


class TransformerLM(Module):
    """GPT-style LM: token + learned position embeddings, N pre-LN blocks,
    final LN, a head tied to the token embedding (or its own with
    ``tie_head=False``).

    Built with its parameters on the ``meta`` device: :meth:`init` (random
    weights from a seed) or ``convert.params_from_numpy`` (weights from the
    JAX package) puts them on a device."""

    def __init__(self, vocab: int, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 6, d_ff: Optional[int] = None,
                 max_len: int = 1024, tie_head: bool = True,
                 remat: bool = False):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.vocab, self.max_len = vocab, max_len
        self.tie_head, self.remat = tie_head, remat
        self.embed = Embedding(vocab, d_model, w_init=normal(0.0, 0.02))
        self.param("pos_embed", (max_len, d_model), normal(0.0, 0.01))
        self.blocks = nn.ModuleList(TransformerBlock(d_model, n_heads, d_ff)
                                    for _ in range(n_layers))
        self.ln_f = LayerNorm(d_model)
        if not tie_head:
            self.head = Linear(d_model, vocab, bias=False,
                               w_init=normal(0.0, 0.02))

    @property
    def device(self) -> torch.device:
        return self.embed.w.device

    @property
    def dtype(self) -> torch.dtype:
        """Compute dtype: the embedding table's, which activations and the
        KV cache inherit."""
        return self.embed.w.dtype

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head: the token embedding's transpose, or ``head``."""
        if self.tie_head:
            return x @ self.embed.w.t().to(x.dtype)
        return x @ self.head.w.to(x.dtype)

    def forward(self, ids: torch.Tensor, *,
                route: Optional[str] = None) -> torch.Tensor:
        """ids [B, T] -> logits [B, T, V]; differentiable (the training
        forward), where the serving methods below run without autograd."""
        T = ids.shape[1]
        x = self.embed(ids)
        x = x + self.pos_embed[:T].to(x.dtype)
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = _remat_block(blk, x, route)
            else:
                x = blk(x, route=route)
        return self._logits(self.ln_f(x))

    def shifted_loss(self, ids_in: torch.Tensor, targets: torch.Tensor, *,
                     mask: Optional[torch.Tensor] = None, positions=None,
                     seq_axis: Optional[str] = None,
                     route: Optional[str] = None) -> torch.Tensor:
        """Mean next-token CE over already-shifted (inputs, targets) pairs;
        ``mask`` (targets' shape) weights positions. ``positions`` and
        ``seq_axis`` belong to sequence sharding (ring attention), which
        the port does not have yet: they raise."""
        if positions is not None or seq_axis is not None:
            raise ValueError("positions / seq_axis (sequence sharding over "
                             "ring attention) are not ported")
        return token_cross_entropy(self(ids_in, route=route), targets, mask)

    def loss(self, ids: torch.Tensor, lengths: Optional[torch.Tensor] = None,
             *, seq_axis: Optional[str] = None,
             route: Optional[str] = None) -> torch.Tensor:
        """Next-token CE of ids [B, T] over positions < length - 1 (all
        T - 1 without ``lengths``)."""
        if seq_axis is not None:
            raise ValueError("loss() shifts ids itself, which is wrong per "
                             "shard under sequence sharding; sequence "
                             "sharding is not ported")
        targets = ids[:, 1:]
        mask = None
        if lengths is not None:
            T = targets.shape[1]
            mask = (torch.arange(T, device=ids.device)[None, :]
                    < (lengths.to(ids.device) - 1)[:, None])
        return self.shifted_loss(ids[:, :-1], targets, mask=mask,
                                 route=route)

    @torch.no_grad()
    def generate_greedy(self, prompt: torch.Tensor, steps: int, *,
                        route: Optional[str] = None) -> torch.Tensor:
        """Greedy continuation by full re-forward per step: prompt
        [B, T0] -> [B, T0+steps]. The correctness reference, not the
        serving path."""
        ids = prompt
        for _ in range(steps):
            logits = self(ids[:, -self.max_len:], route=route)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            ids = torch.cat([ids, nxt[:, None].to(ids.dtype)], dim=1)
        return ids

    # -- incremental decoding (the serving path) ---------------------------
    @torch.no_grad()
    def prefill(self, prompt: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, *,
                kv_dtype: Optional[str] = None,
                pad_to: Optional[int] = None,
                route: Optional[str] = None,
                into: Optional[Cell] = None) -> Tuple[Cell, torch.Tensor]:
        """Run the prompt once; return (cell, last logits [B, V]). The cell
        holds per-layer caches ``k{i}``/``v{i}`` [B, pad, H, Dh] padded to
        ``pad_to`` (default max_len) and the write position ``pos`` [B].
        ``into``: a cell of :meth:`empty_cell` whose tensors take all of it
        in place (the padding rewritten too), in place of new tensors.

        ``lengths`` [B] makes the batch ragged: prompts are right-padded,
        attention stays causal with no kv_lens (a padded tail row is never
        read by a live query), and each sample's logits are taken at
        ``lengths - 1``.

        ``kv_dtype="int8"`` stores the caches as symmetric int8 rows
        (:func:`ops.cuda_kernels.quantize_kv`) with per-(position, head) f32
        scales ``k{i}_scale``/``v{i}_scale`` [B, pad, H], padded with 1.0 so
        that a dequantized padding row stays finite. The prompt's own
        attention runs at full precision: only later cache reads see the
        quantization."""
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} "
                             "(None or 'int8')")
        B, T0 = prompt.shape
        limit = self.max_len if pad_to is None else min(pad_to, self.max_len)
        if limit < T0:
            raise ValueError(f"prefill cache limit {limit} (pad_to/max_len) "
                             f"is narrower than the prompt ({T0})")
        x = self.embed(prompt)
        x = x + self.pos_embed[:T0].to(x.dtype)
        if lengths is None:
            pos = torch.full((B,), T0, dtype=torch.int32, device=x.device)
        else:
            pos = lengths.to(device=x.device, dtype=torch.int32)
        cell: Cell = {"pos": pos}
        pad = (0, 0, 0, 0, 0, limit - T0)          # dim 1 of [B, T, H, Dh]

        def put(nm, t, value=0.0):
            if into is None:
                cell[nm] = F.pad(t, pad[8 - 2 * t.dim():], value=value)
                return
            dst = cell[nm] = into[nm]
            dst[:, :T0] = t
            dst[:, T0:].fill_(value)
        if into is not None:
            if into["k0"].shape[:2] != (B, limit):
                raise ValueError(f"the cell holds {tuple(into['k0'].shape[:2])}"
                                 f" rows, the prefill makes ({B}, {limit})")
            cell["pos"] = into["pos"]
            cell["pos"].copy_(pos)
        for i, blk in enumerate(self.blocks):
            q, k, v = blk.heads(x)
            x = blk.finish(x, blk.attend(q, k, v, route=route))
            if kv_dtype == "int8":
                for nm, t in ((f"k{i}", k), (f"v{i}", v)):
                    codes, scale = ck.quantize_kv(t)
                    put(nm, codes)
                    put(nm + "_scale", scale, value=1.0)
            else:
                put(f"k{i}", k)
                put(f"v{i}", v)
        x = self.ln_f(x)
        # only the rows whose logits are returned go through the head
        if lengths is None:
            last = x[:, -1]
        else:
            last = x[torch.arange(B, device=x.device), pos.long() - 1]
        return cell, self._logits(last)

    def empty_cell(self, B: int, kv_dtype: Optional[str] = None) -> Cell:
        """A cell of B rows of max_len positions with the tensors
        :meth:`prefill` makes (zeroed; int8 scales 1.0), for its ``into``."""
        blk = self.blocks[0]
        shape = (B, self.max_len, blk.n_heads, blk.d_head)
        dev = self.device
        cell: Cell = {"pos": torch.zeros((B,), dtype=torch.int32, device=dev)}
        for i in range(len(self.blocks)):
            for nm in (f"k{i}", f"v{i}"):
                if kv_dtype == "int8":
                    cell[nm] = torch.zeros(shape, dtype=torch.int8, device=dev)
                    cell[nm + "_scale"] = torch.ones(
                        shape[:3], dtype=torch.float32, device=dev)
                else:
                    cell[nm] = torch.zeros(shape, dtype=self.dtype, device=dev)
        return cell

    def _append_rows(self, cell: Cell, i: int, k: torch.Tensor,
                     v: torch.Tensor, at,
                     keep: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, ...]:
        """Write this step's k/v rows ([B, S, H, Dh]) of layer ``i`` into
        the cell's dense caches IN PLACE at the rows ``at`` (from
        :meth:`_rows_at`), quantizing them when the cell is int8; returns
        the caches (kc, vc, k_scale, v_scale), the scales None when not
        int8. Where JAX returns updated caches, the returned cell holds the
        same tensors: no copy of the cache per step. Where ``keep`` [B]
        is False the write puts back what the place held (a write JAX
        drops), with no host sync."""
        kc, vc = cell[f"k{i}"], cell[f"v{i}"]
        ksc = cell.get(f"k{i}_scale")
        vsc = cell.get(f"v{i}_scale")

        def put(dst, new):
            if keep is not None:
                m = keep.view(-1, *([1] * (new.dim() - 1)))
                new = torch.where(m, new, dst[at])
            dst[at] = new
        if ksc is not None:
            k, ks = ck.quantize_kv(k)
            v, vs = ck.quantize_kv(v)
            put(ksc, ks)
            put(vsc, vs)
        put(kc, k.to(kc.dtype))
        put(vc, v.to(vc.dtype))
        return kc, vc, ksc, vsc

    @staticmethod
    def _rows_at(pos: torch.Tensor, S: int, rows: int):
        """The (batch, row) index of a write of S rows at pos..pos+S-1 into
        a cache of ``rows`` rows, its start clamped to [0, rows - S] as
        ``jax.lax.dynamic_update_slice`` clamps it (a finished request's
        overshoot past max_len rewrites the last rows, as in JAX)."""
        start = torch.clamp(pos.long(), 0, rows - S)
        r = start[:, None] + torch.arange(S, device=pos.device)
        return torch.arange(pos.shape[0], device=pos.device)[:, None], r

    def _embed_at(self, tokens: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        """Token + position embeddings of tokens [B, S] at positions
        [B, S], the positions clamped to max_len - 1 as JAX's gather
        clamps them."""
        x = self.embed(tokens)
        pe = self.pos_embed[torch.clamp(positions.long(), max=self.max_len - 1)]
        return x + pe.to(x.dtype)

    @torch.no_grad()
    def decode_step(self, cell: Cell, tokens: torch.Tensor, *,
                    cache_len: Optional[int] = None,
                    route: Optional[str] = None
                    ) -> Tuple[torch.Tensor, Cell]:
        """One incremental step against the dense caches of a
        :meth:`prefill` cell: tokens [B] -> (logits [B, V], new cell). The
        step's k/v row is written at ``pos`` (in place, :meth:`_append_rows`)
        and the read goes through :func:`ops.cuda_kernels.decode_attention`
        over the first ``cache_len`` rows (default max_len): the bucketed
        read bound, which callers keep above every live position. An int8
        cell quantizes the appended row and dequantizes in the read."""
        pos = cell["pos"]
        L = self.max_len if cache_len is None else min(cache_len,
                                                       self.max_len)
        x = self._embed_at(tokens[:, None], pos[:, None])   # [B, 1, D]
        at = self._rows_at(pos, 1, cell["k0"].shape[1])
        for i, blk in enumerate(self.blocks):
            q, k, v = blk.heads(x)                          # [B, 1, H, Dh]
            kc, vc, ksc, vsc = self._append_rows(cell, i, k, v, at)
            o = ck.decode_attention(
                q[:, 0], kc[:, :L], vc[:, :L], pos,
                scale=blk.d_head ** -0.5,
                k_scale=None if ksc is None else ksc[:, :L],
                v_scale=None if vsc is None else vsc[:, :L], route=route)
            x = blk.finish(x, o[:, None])
        logits = self._logits(self.ln_f(x))
        new_cell = dict(cell)
        new_cell["pos"] = pos + 1
        return logits[:, 0], new_cell

    @torch.no_grad()
    def decode_step_paged(self, cell: Cell, tokens: torch.Tensor,
                          tables: torch.Tensor, *,
                          route: Optional[str] = None
                          ) -> Tuple[torch.Tensor, Cell]:
        """One step against a paged cache: tokens [B] -> (logits [B, V],
        new cell). The cell holds per-layer page pools ``k{i}``/``v{i}``
        [P, bs, H, Dh] shared by every request and ``pos`` [B]; ``tables``
        [B, NB] int32 names the page of each request's positions
        ``j*bs .. (j+1)*bs-1`` (sliced by the caller to the read bound).

        The step's k/v row is written at page ``tables[b, pos//bs]``, row
        ``pos % bs``. Where JAX returns new pools, the port writes into the
        pools IN PLACE (the returned cell holds the same tensors): no copy
        of the pool per step. Drained slots' tables point at the null page
        0, which absorbs their writes. A position past the table
        (``pos // bs >= NB``: a finished request's discarded overshoot)
        writes nothing, as JAX's out-of-range scatter drops its write: the
        pools keep what they held. Its embedding position is clamped to
        max_len - 1 as JAX clamps its gather. int8 pools (with
        ``k{i}_scale``/``v{i}_scale`` [P, bs, H] scale pools) quantize the
        appended row and dequantize in the read."""
        pos = cell["pos"]
        bs = cell["k0"].shape[1]
        NB = tables.shape[1]
        blk = pos.long() // bs
        in_table = blk < NB
        page = tables.long().gather(1, torch.clamp(blk, max=NB - 1)[:, None])
        at = (page[:, 0], pos.long() % bs)
        x = self._embed_at(tokens[:, None], pos[:, None])   # [B, 1, D]
        for i, blk in enumerate(self.blocks):
            q, k, v = blk.heads(x)                          # [B, 1, H, Dh]
            kp, vp, ksp, vsp = self._append_rows(cell, i, k[:, 0], v[:, 0],
                                                 at, keep=in_table)
            o = ck.paged_decode_attention(q[:, 0], kp, vp, tables, pos,
                                          scale=blk.d_head ** -0.5,
                                          k_scale=ksp, v_scale=vsp,
                                          route=route)
            x = blk.finish(x, o[:, None])
        logits = self._logits(self.ln_f(x))
        new_cell = dict(cell)
        new_cell["pos"] = pos + 1
        return logits[:, 0], new_cell

    @torch.no_grad()
    def prefill_paged(self, pools: Dict[str, torch.Tensor],
                      tokens: torch.Tensor, offsets: torch.Tensor,
                      lengths: torch.Tensor, tables: torch.Tensor
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Prefill from an offset over pre-populated block tables — the
        prefix-cache admission (``serving/paged.py``): each sample's first
        ``offsets[b]`` positions already sit in shared pool pages, so only
        the suffix ``tokens[b, :lengths[b]]`` runs the forward.

        tokens [B, S] (right-padded suffixes); offsets, lengths [B]; tables
        [B, NB] covering positions 0 .. offsets + lengths - 1 (the suffix's
        positions land in pages the slot owns; shared pages are never
        written). ``pools``: ``k{i}``/``v{i}`` [P, bs, H, Dh] (and
        ``*_scale`` [P, bs, H] for int8), written IN PLACE (the returned
        dict holds the same tensors). Returns (pools, logits [B, V] at
        each sample's last suffix position).

        Each layer scatters the suffix's k/v rows into the pools (int8
        pools quantize them; padded rows land in the null page 0), then
        attends over the gathered pages with the suffix's own rows
        overlaid at full precision (the full prefill's precision: only the
        cache read is quantized), in ``_dense_attention``'s op order
        (f32 einsum, * scale, causal mask j <= offset + i, softmax,
        einsum, cast): a zero-offset call reproduces the plain full
        prefill. Plain PyTorch, as JAX's is plain jnp."""
        B, S = tokens.shape
        bs = pools["k0"].shape[1]
        NB = tables.shape[1]
        L = NB * bs
        dev = tokens.device
        offsets = offsets.to(dev).long()
        lengths = lengths.to(dev).long()
        tables = tables.to(dev).long()
        iota = torch.arange(S, device=dev)
        positions = offsets[:, None] + iota[None, :]              # [B, S]
        live = iota[None, :] < lengths[:, None]
        gpos = torch.clamp(positions, 0, self.max_len - 1)
        blk_idx = torch.clamp(gpos // bs, 0, NB - 1)
        pages = torch.where(live, tables.gather(1, blk_idx),
                            torch.zeros_like(blk_idx))
        rows = gpos % bs
        jpos = torch.arange(L, device=dev)
        rel = jpos[None, :] - offsets[:, None]                    # [B, L]
        own = (rel >= 0) & (rel < lengths[:, None])
        rel_c = torch.clamp(rel, 0, S - 1)
        causal = jpos[None, None, None, :] <= positions[:, None, :, None]

        def read(pool, scale_pool, own_rows):
            g = ck.gather_pages(pool, tables).float()             # [B, L, H, D]
            if scale_pool is not None:
                g = g * ck.gather_pages(scale_pool, tables)[..., None]
            idx = rel_c[:, :, None, None].expand((B, L) + own_rows.shape[2:])
            o = torch.gather(own_rows.float(), 1, idx)
            return torch.where(own[:, :, None, None], o, g)

        x = self._embed_at(tokens, gpos)
        for i, blk in enumerate(self.blocks):
            q, k, v = blk.heads(x)                                # [B, S, H, Dh]
            for nm, t in ((f"k{i}", k), (f"v{i}", v)):
                if nm + "_scale" in pools:
                    t8, sc = ck.quantize_kv(t)
                    pools[nm + "_scale"][pages, rows] = sc
                    pools[nm][pages, rows] = t8
                else:
                    pools[nm][pages, rows] = t.to(pools[nm].dtype)
            kr = read(pools[f"k{i}"], pools.get(f"k{i}_scale"), k)
            vr = read(pools[f"v{i}"], pools.get(f"v{i}_scale"), v)
            sc = torch.einsum("bthd,bjhd->bhtj", q.float(), kr) \
                * blk.d_head ** -0.5
            sc = torch.where(causal, sc, ck._NEG)
            p = torch.softmax(sc, dim=-1)
            o = torch.einsum("bhtj,bjhd->bthd", p, vr).to(q.dtype)
            x = blk.finish(x, o)
        last = torch.clamp(lengths - 1, 0, S - 1)
        x = self.ln_f(x[torch.arange(B, device=dev), last])
        return pools, self._logits(x)

    @torch.no_grad()
    def verify_step(self, cell: Cell, tokens: torch.Tensor, *,
                    cache_len: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Cell]:
        """Multi-token incremental step — the speculative-decoding verify:
        tokens [B, S] are appended to the dense caches (rows
        pos..pos+S-1, in place) and scored in one pass, returning (logits
        [B, S, V], new cell) where logits[:, i] is the next-token
        distribution after tokens[:, :i+1]. Query i attends rows
        j <= pos+i. Plain PyTorch math, as the JAX method is plain einsums
        outside any kernel; int8 cells quantize the span on append and
        dequantize the read. On the card it runs inside the speculative
        round's CUDA graph (``SpeculativeDecoder._round_body``)."""
        B, S = tokens.shape
        pos = cell["pos"]
        L = self.max_len if cache_len is None else min(cache_len,
                                                       self.max_len)
        positions = pos.long()[:, None] + torch.arange(S, device=pos.device)
        x = self._embed_at(tokens, positions)               # [B, S, D]
        at = self._rows_at(pos, S, cell["k0"].shape[1])
        valid = (torch.arange(L, device=pos.device)[None, None, None, :]
                 <= positions[:, None, :, None])            # [B, 1, S, L]
        for i, blk in enumerate(self.blocks):
            q, k, v = blk.heads(x)                          # [B, S, H, Dh]
            kc, vc, ksc, vsc = self._append_rows(cell, i, k, v, at)
            kr, vr = kc[:, :L].float(), vc[:, :L].float()
            if ksc is not None:
                kr = kr * ksc[:, :L, :, None]
                vr = vr * vsc[:, :L, :, None]
            s = torch.einsum("bihd,bjhd->bhij",
                             q.float() * blk.d_head ** -0.5, kr)
            s = torch.where(valid, s, ck._NEG)
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            p = p / p.sum(dim=-1, keepdim=True)
            x = blk.finish(x, torch.einsum("bhij,bjhd->bihd", p, vr))
        logits = self._logits(self.ln_f(x))
        new_cell = dict(cell)
        new_cell["pos"] = pos + S
        return logits, new_cell

    @torch.no_grad()
    def generate_fused(self, prompt: torch.Tensor, steps: int, *,
                       bucket: Optional[int] = None,
                       kv_dtype: Optional[str] = None,
                       sample: str = "greedy", top_k: Optional[int] = None,
                       temperature: float = 1.0,
                       generator: Optional[torch.Generator] = None,
                       route: Optional[str] = None) -> torch.Tensor:
        """The decode loop: :meth:`prefill` emits the first token, each of
        the ``steps - 1`` later ones is one :meth:`decode_step` (cache
        append, the read through kernel #4 or #5, MLP, logits) and one
        sample. prompt [B, T0] -> [B, T0+steps]. The greedy tokens are
        :meth:`generate_greedy`'s, token for token (up to the kernels'
        summation order, and int8's quantization).

        ``bucket`` bounds each step's cache read to the next multiple of
        ``bucket`` past its position instead of max_len (a 200-token decode
        at max_len 1024 with bucket 256 reads 256-row slices, not 1024).

        ``sample="topk"`` draws from the ``top_k`` largest logits at
        ``temperature`` with ``generator`` (a ``torch.Generator`` on the
        model's device, in place of JAX's PRNG key); greedy ignores both.

        As the JAX method compiles each step into one dispatch, each step
        here is one CUDA graph on the card (:meth:`graph_cache`): the
        prefill and its sample (:meth:`_prefill_body`) per (B, T0,
        kv_dtype, sample, top_k), the decode step and its sample
        (:meth:`_decode_body`) per (B, cache_len, kv_dtype, sample,
        top_k). The caches and the position live in one cell per (B,
        kv_dtype) that the cache keeps (:meth:`empty_cell`): the prefill
        writes it in place and the steps carry it, with the token, from
        step to step. The generator is no part of a key: a fresh one for
        each call replays the same graphs."""
        B, T0 = prompt.shape
        if T0 + steps > self.max_len:
            raise ValueError(f"prompt_len ({T0}) + steps ({steps}) exceeds "
                             f"max_len ({self.max_len})")
        if sample not in ("greedy", "topk"):
            raise ValueError(f"unknown sample {sample!r}")
        if sample == "topk" and (top_k is None or generator is None):
            raise ValueError("sample='topk' needs top_k and generator")
        if steps == 0:
            return prompt
        graphs = self.graph_cache()
        cell = graphs.buffer(("cell", B, kv_dtype, self.dtype),
                             lambda: self.empty_cell(B, kv_dtype))
        draw = dict(sample=sample, top_k=top_k, temperature=temperature,
                    generator=generator, route=route)
        cur, tok = graphs.run("prefill", self._prefill_body,
                              {"cell": cell, "prompt": prompt},
                              static=dict(kv_dtype=kv_dtype, **draw),
                              donate=("cell",))
        toks = [tok]
        for j in range(1, steps):
            pos = T0 + j                       # max live position + 1
            cache_len = None if bucket is None else min(
                -(-pos // bucket) * bucket, self.max_len)
            cur, tok = graphs.run(
                "decode", self._decode_body, {"cell": cell, "cur": cur},
                static=dict(cache_len=cache_len, kv_dtype=kv_dtype, **draw),
                donate=("cell", "cur"))
            toks.append(tok)
        return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)

    @torch.no_grad()
    def _prefill_body(self, cell, prompt, *, kv_dtype, sample, top_k,
                      temperature, generator, route):
        """The prefill into ``cell`` in place and its sample: (the token as
        the decode loop's carried input, the token as an output)."""
        _, last = self.prefill(prompt, kv_dtype=kv_dtype, route=route,
                               into=cell)
        tok = _sample_token(last, sample, top_k, temperature,
                            generator).to(prompt.dtype)
        return tok.clone(), tok

    @torch.no_grad()
    def _decode_body(self, cell, cur, *, cache_len, kv_dtype, sample, top_k,
                     temperature, generator, route):
        """One step of the decode loop: :meth:`decode_step` on token ``cur``
        and its sample, written back into the carried ``cell["pos"]`` and
        ``cur`` in place (the caches are written in place by the step).
        Returns (cur, the token). ``kv_dtype`` only keys the graph."""
        logits, new = self.decode_step(cell, cur, cache_len=cache_len,
                                       route=route)
        tok = _sample_token(logits, sample, top_k, temperature,
                            generator).to(cur.dtype)
        cell["pos"].copy_(new["pos"])
        cur.copy_(tok)
        return cur, tok

    #: the JAX package's name for the greedy dense-cache loop, kept for its
    #: callers: one loop, :meth:`generate_fused` (the JAX scans run one step
    #: more than they emit; this loop does not)
    generate_cached = generate_fused


def _sample_token(logits: torch.Tensor, sample: str, top_k: Optional[int],
                  temperature: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax, or a draw from the softmax of the ``top_k`` largest
    logits over ``temperature`` (JAX's categorical over the same set).

    The draw is ``torch.multinomial``'s own for one sample, argmax(p / q)
    with q ~ Exp(1), without its host-side checks of p (which read the
    card and so cannot run inside a CUDA graph)."""
    if sample == "greedy":
        return torch.argmax(logits, dim=-1)
    v, idx = torch.topk(logits.float(), top_k, dim=-1)
    p = torch.softmax(v / temperature, dim=-1)
    q = torch.empty_like(p).exponential_(1.0, generator=generator)
    return idx.gather(1, torch.argmax(p / q, dim=-1)[:, None])[:, 0]
