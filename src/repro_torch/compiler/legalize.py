"""Legalization passes: arbitrary layer graphs -> CUTIE-shaped conv chains.

Every pass maps a :class:`~repro_torch.compiler.graph.Graph` to a new
Graph and is *exact*: the lowered graph computes bit-identical trit
activations.  The passes, in the order `compile_graph` runs them:

* :func:`ternarize_weights` - latent float weights -> pure trits via
  per-output-channel TWN (`repro_torch.core.ternary`, the arithmetic of
  ``engine.compile_layer``), with the ternary scale alpha folded into the
  node's BN (gamma' = gamma * alpha, beta' = gamma * (bias - mean) / s +
  beta).  After it the graph is in the hardware's value domain, so the
  structural passes below splice weight tensors without re-quantizing.
* :func:`fuse_pooling` - standalone max pools merge into their producing
  conv (the merged-pooling datapath, paper Fig. 5); any other pool
  becomes an identity 1x1 conv with merged pooling.
* :func:`lower_dense` - dense heads become KxK valid convolutions over
  the full feature map: the (H*W*C, D_out) matrix reshapes onto the OCU
  weight buffer axes (H, W, C, D_out), exact for the NHWC flatten order.
* :func:`lower_residual` - residual adds become feed-forward layers: the
  skip operand rides through the body convs as passthrough channels (one
  +1 center tap each, every other tap a zero weight the hardware
  silences), and the add becomes a 1x1 conv summing the body and skip
  channel groups under the add's folded thresholds.

:func:`linearize` checks that the legalized graph is one conv chain and
returns its nodes in execution order.  Channel padding to the TCU width
runs after lowering and optimization, on the compiled program
(:func:`repro_torch.compiler.optimize.pad_program_channels`).

The passes keep each weight tensor on its device; numpy weights become
CPU tensors.  The reference is `repro.compiler.legalize`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.compiler.graph import Graph, GraphError, Node, _err
from repro_torch.core import engine, folding
from repro_torch.core import ternary as T

_ID_BN = {"gamma": 1.0, "beta": 0.0, "mean": 0.0, "var": 1.0}
# Identity BN on an integer z gives thresholds at about +-0.5/sqrt(1+eps):
# strictly inside (0, 1), so the compare is exact on integer accumulators
# (and stays exact under avg-pool threshold scaling).


def _np(w) -> np.ndarray:
    """A weight or BN array as numpy, wherever it lives."""
    if isinstance(w, torch.Tensor):
        return w.detach().cpu().numpy()
    return np.asarray(w)


def _is_trits(w) -> bool:
    vals = np.unique(_np(w))
    return bool(np.all(np.isin(vals, (-1.0, 0.0, 1.0))))


def _bn_vec(bn: dict, key: str, c: int) -> np.ndarray:
    return np.broadcast_to(
        _np(bn.get(key, _ID_BN.get(key, 0.0))).astype(np.float32), (c,)
    ).copy()


def _extend_bn(bn: dict, c: int, extra: int) -> dict:
    """Broadcast BN vectors to (c,) and append `extra` identity channels."""
    out = dict(bn)
    for key in ("gamma", "beta", "mean", "var", "bias"):
        if key not in bn and key not in _ID_BN:
            continue
        vec = _bn_vec(bn, key, c)
        out[key] = np.concatenate(
            [vec, np.full((extra,), _ID_BN.get(key, 0.0), np.float32)])
    return out


def _weights_like(a: np.ndarray, like) -> torch.Tensor:
    """A new weight array on the device of the node's former weights."""
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.as_tensor(a, device=dev)


# -- ternarize ---------------------------------------------------------------


def ternarize_weights(graph: Graph) -> Graph:
    """TWN-quantize latent float weights and fold alpha into BN: the
    ``compile_layer`` arithmetic, so the thresholds are bit-identical to
    compiling the float node directly."""
    g = graph.copy()
    for node in g.nodes.values():
        if node.op not in ("conv", "dense") or _is_trits(node.weights):
            continue
        w = torch.as_tensor(node.weights, dtype=torch.float32)
        dev = w.device
        axes = tuple(range(w.dim() - 1))
        delta = T.twn_delta(w, axis=axes, ratio=node.delta_ratio)
        trits = T.ternarize(w, delta)
        alpha = T.twn_scale(w, trits, axis=axes).reshape(-1)
        c = w.shape[-1]
        bn = node.bn

        def f32(key, default):
            return torch.as_tensor(bn.get(key, default), dtype=torch.float32,
                                   device=dev)

        gamma, beta = f32("gamma", 1.0), f32("beta", 0.0)
        mean, var, bias = f32("mean", 0.0), f32("var", 1.0), f32("bias", 0.0)
        eps = float(bn.get("eps", 1e-5))
        s = folding.sqrt_rn(var + eps)
        node.weights = trits.to(torch.int8)
        node.bn = {
            "gamma": (gamma * alpha).expand(c).clone(),
            # the whole (bias - mean)/s shift collapses into beta, so the
            # folded compare constant c is reproduced bit for bit
            "beta": (gamma * (bias - mean) / s + beta).expand(c).clone(),
            "mean": torch.zeros(c, device=dev),
            "var": var.expand(c).clone(),
            "eps": eps,
        }
    return g


# -- pooling -----------------------------------------------------------------


def fuse_pooling(graph: Graph) -> Graph:
    """Merge standalone max-pool nodes into the producing conv; otherwise
    replace the pool with an identity 1x1 conv carrying the merged pool.

    Only max pooling may fuse into the producer: the merged datapath pools
    pre-threshold integers, which for max equals pooling the trits (the
    compare chain is monotone in sign(g)*z) but for avg does not equal the
    pool node's trit-domain semantics (ternarize(mean of trits)), so avg
    always takes the identity-conv path.
    """
    g = graph.copy()
    shapes = g.infer_shapes()
    for name in [n.name for n in g.nodes.values() if n.op == "pool"]:
        node = g.nodes[name]
        producer = g.nodes[node.inputs[0]]
        if (producer.op == "conv" and producer.pool is None
                and node.pool[0] == "max"
                and g.consumers(producer.name) == [name]):
            producer.pool = node.pool
            for cons in g.consumers(name):
                cnode = g.nodes[cons]
                cnode.inputs = tuple(producer.name if i == name else i
                                     for i in cnode.inputs)
            if g.output == name:
                g.set_output(producer.name)
            del g.nodes[name]
        else:
            c = shapes[node.inputs[0]][2]
            eye = np.zeros((1, 1, c, c), np.int8)
            eye[0, 0, np.arange(c), np.arange(c)] = 1
            g.nodes[name] = Node(
                op="conv", name=name, inputs=node.inputs,
                weights=_weights_like(eye, producer.weights), bn={},
                stride=(1, 1), padding=True, pool=node.pool)
    return g


# -- dense -> conv -----------------------------------------------------------


def lower_dense(graph: Graph, instance: engine.CutieInstance) -> Graph:
    """Dense (D_in, D_out) over a flattened (H, W, C) map -> KxK valid conv.

    Legal when the map is 1x1 (K=1) or square with odd H <= instance K,
    i.e. when the flattened input fits the OCU weight buffer raster.  The
    reshape (H, W, C, D_out) matches the NHWC flatten order bit for bit.
    """
    g = graph.copy()
    shapes = g.infer_shapes()
    for idx, node in enumerate(list(g.nodes.values())):
        if node.op != "dense":
            continue
        h, w, c = shapes[node.inputs[0]]
        if (h, w) != (1, 1) and not (h == w and h % 2 == 1
                                     and h <= instance.k):
            raise _err(node, idx, (
                f"dense over a {h}x{w}x{c} feature map is not mappable to "
                f"the OCU buffer (needs 1x1 or odd square <= K={instance.k};"
                " insert pooling upstream)"))
        if c > instance.n_i:
            raise _err(node, idx, f"dense input channels {c} exceed "
                       f"N_I={instance.n_i}")
        d_out = np.shape(node.weights)[1]
        wq = torch.as_tensor(node.weights).reshape(h, w, c, d_out)
        # the valid (unpadded) conv collapses the map to 1x1; for a 1x1 map
        # padding is moot either way
        g.nodes[node.name] = dataclasses.replace(
            node, op="conv", weights=wq, stride=(1, 1), padding=False,
            pool=None)
    return g


# -- residual add ------------------------------------------------------------


def _body_chain(g: Graph, head: str, skip: str) -> list[str] | None:
    """Walk producers from `head` down to `skip`; return [skip-side ..
    head] or None if the walk leaves a single-input conv chain."""
    path, cur = [], head
    while cur != skip:
        node = g.nodes[cur]
        if node.op != "conv" or len(node.inputs) != 1:
            return None
        path.append(cur)
        cur = node.inputs[0]
        if len(path) > len(g.nodes):
            return None
    return list(reversed(path))


def lower_residual(graph: Graph) -> Graph:
    """Rewrite add nodes into feed-forward form via passthrough channels.

    The skip tensor is carried through every body conv as `cs` extra
    channels whose filters are zero except one +1 center tap (identity on
    trits under identity BN).  The add node becomes a 1x1 conv over
    [body_channels | skip_channels] with +1 taps on both groups and the
    add's own folded thresholds.
    """
    g = graph.copy()
    for name in [n.name for n in g.nodes.values() if n.op == "add"]:
        node = g.nodes[name]
        idx = g.index(name)
        a, b = node.inputs
        if a == b:
            raise _err(node, idx, "self-add (x + x) is not representable "
                       "with trit weights")
        body, skip = _body_chain(g, a, b), b
        if body is None:
            body, skip = _body_chain(g, b, a), a
        if body is None:
            raise _err(node, idx, (
                "residual pattern unsupported: one operand must reach the "
                "other through a single-consumer chain of conv nodes"))
        shapes = g.infer_shapes()
        cs = shapes[skip][2]
        c_body = shapes[body[-1]][2]
        if c_body != cs:
            raise _err(node, idx, f"add operands have different channel "
                       f"counts ({c_body} vs {cs})")
        for j, bname in enumerate(body):
            bnode = g.nodes[bname]
            bidx = g.index(bname)
            want = [body[j + 1] if j + 1 < len(body) else name]
            if g.consumers(bname) != want:
                raise _err(bnode, bidx, "residual body layer has consumers "
                           "outside the block; cannot widen it")
            if (bnode.stride != (1, 1) or not bnode.padding
                    or bnode.pool is not None):
                raise _err(bnode, bidx, "residual body layers must be "
                           "stride-1, padded, and non-pooling")
            if not _is_trits(bnode.weights):
                raise GraphError("lower_residual requires ternarized "
                                 "weights (run ternarize_weights first)")
            w = _np(bnode.weights).astype(np.int8)
            k, _, cin, cout = w.shape
            first = j == 0
            wn = np.zeros((k, k, cin + (0 if first else cs), cout + cs),
                          np.int8)
            wn[:, :, :cin, :cout] = w
            for i in range(cs):
                src = i if first else cin + i
                wn[k // 2, k // 2, src, cout + i] = 1
            bnode.weights = _weights_like(wn, bnode.weights)
            bnode.bn = _extend_bn(bnode.bn, cout, cs)
        wadd = np.zeros((1, 1, c_body + cs, c_body), np.int8)
        wadd[0, 0, np.arange(c_body), np.arange(c_body)] = 1
        wadd[0, 0, c_body + np.arange(cs), np.arange(cs)] = 1
        g.nodes[name] = Node(
            op="conv", name=name, inputs=(body[-1],),
            weights=_weights_like(wadd, g.nodes[body[-1]].weights),
            bn=dict(node.bn), stride=(1, 1), padding=True, pool=None)
    return g


# -- chain extraction --------------------------------------------------------


def linearize(graph: Graph) -> list[str]:
    """Verify the legalized graph is one conv chain input -> output and
    return node names in execution order."""
    order, cur = [], Graph.INPUT
    seen = {cur}
    while cur != graph.output:
        cons = graph.consumers(cur)
        if len(cons) != 1:
            node = graph.nodes[cur]
            raise _err(node, graph.index(cur),
                       f"not a linear chain: {len(cons)} consumers {cons}")
        cur = cons[0]
        node = graph.nodes[cur]
        if node.op != "conv":
            raise _err(node, graph.index(cur),
                       f"unlowered {node.op!r} node after legalization")
        if cur in seen:
            raise _err(node, graph.index(cur), "cycle in graph")
        seen.add(cur)
        order.append(cur)
    if len(order) != len(graph):
        extra = [n for n in graph.nodes if n not in seen]
        raise GraphError(f"dead nodes not on the input->output chain: "
                         f"{extra}")
    return order
