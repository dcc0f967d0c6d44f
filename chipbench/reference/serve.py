"""The reference's forward over whole sequences, layer by layer: each
layer's weights are cast to float32 once and run over every sequence, so
one layer's float32 weights and the sequences' activations are all that
live at a time."""
from __future__ import annotations

import torch

from chipbench.reference import model as M


@torch.no_grad()
def forward(weights: dict, dims, seqs, at, precs=(M.FP32,), on_layer=None):
    """Logits of each sequence ``seqs[i]`` (token ids [T_i]) at its
    positions ``at[i]`` (an index tensor), for each precision in ``precs``:
    ``out[p][i]`` is [len(at[i]), V] float32.  ``on_layer(l, i, kvs)``, where
    given, sees layer ``l``'s keys (after the rotary embedding) and values
    of sequence ``i``, one (k, v) pair [T_i, KV, d] a precision."""
    xs = [[weights["tok_emb"][s].float()[None] for s in seqs] for _ in precs]
    for li in range(dims.n_layers):
        w = {k: weights[k][li].float() for k in M.LAYER_KEYS}
        for i, s in enumerate(seqs):
            pos = torch.arange(s.shape[0], device=s.device)
            kvs = []
            for p, prec in enumerate(precs):
                xs[p][i], (k, v) = M.layer(xs[p][i], w, pos, dims.rope_theta,
                                           dims.norm_eps, prec)
                kvs.append((k[0], v[0]))
            if on_layer is not None:
                on_layer(li, i, kvs)
            del kvs
        del w
    final, head = weights["final_norm"].float(), weights["head"].float()
    return [[M.logits(x[:, at[i]], final, head, dims.norm_eps, prec)[0]
             for i, x in enumerate(xs[p])] for p, prec in enumerate(precs)]
