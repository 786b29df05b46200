"""Layer-graph IR for the CUTIE compiler.

A :class:`Graph` is a small DAG of layer nodes over trit activations —
``conv`` / ``dense`` / ``pool`` / ``add`` (residual) — carrying *float*
(or already-ternary) weights plus BN statistics, as numpy arrays or
tensors.  It is the compiler's
input language: anything expressible here is legalized and lowered to a
bit-true :class:`repro_torch.core.engine.CutieProgram` by
:func:`repro_torch.compiler.compile_graph`.

Node semantics (all activations are trits in {-1, 0, +1}):

* ``input``  — the (H, W, C) trit feature map fed to the program.
* ``conv``   — z = conv(x, w); out = ternarize(BN(alpha * z)) with the
  usual folded two-threshold compare; optional merged pooling happens on
  the pre-threshold integers exactly like ``engine.compile_layer``.
* ``dense``  — out = ternarize(BN(flatten(x) @ w)); legalized onto the
  OCU weight buffer as a KxK valid convolution (generalizing
  ``engine.dense_as_conv``).
* ``pool``   — max: elementwise max of trits over the window; avg:
  ternarize(mean of trits, 0.5).  Legalized by fusing into the producing
  conv (bit-exact) or by inserting an identity 1x1 conv.
* ``add``    — out = ternarize(BN(a + b)) for equal-shape trit tensors;
  legalized by carrying the skip operand through the body layers as
  passthrough channels (zero-weight — i.e. hardware-silenced — except a
  single center tap).

Usage::

    g = Graph(in_channels=6, in_hw=(12, 12))
    h = g.conv(w0, bn0, pool=("max", 2))
    s = h
    h = g.conv(w1, bn1)
    h = g.add(h, s)                 # residual join
    g.dense(w_head)                 # classifier head
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core import engine


class GraphError(ValueError):
    """Graph validation/legalization error, naming the offending node."""


def _err(node: "Node", idx: int, msg: str) -> GraphError:
    return GraphError(f"node {idx} ({node.name!r}, op={node.op}): {msg}")


@dataclasses.dataclass
class Node:
    """One IR node.  ``weights``/``bn`` meaning depends on ``op``."""
    op: str                          # input | conv | dense | pool | add
    name: str
    inputs: tuple[str, ...]
    weights: Any = None              # conv (K,K,Cin,Cout); dense (Din,Dout)
    bn: dict = dataclasses.field(default_factory=dict)
    stride: tuple[int, int] = (1, 1)
    padding: bool = True
    pool: tuple[str, int] | None = None
    delta_ratio: float = 0.7


class Graph:
    """Insertion-ordered layer DAG with a single input and a single output
    (the last node added, unless overridden via ``set_output``)."""

    INPUT = "input"

    def __init__(self, in_channels: int, in_hw: tuple[int, int] = (32, 32)):
        self.in_channels = int(in_channels)
        self.in_hw = (int(in_hw[0]), int(in_hw[1]))
        self.nodes: dict[str, Node] = {}
        self.nodes[self.INPUT] = Node(op="input", name=self.INPUT, inputs=())
        self._tail = self.INPUT
        self._counter = 0

    # -- construction -------------------------------------------------------

    def _register(self, node: Node) -> str:
        if node.name in self.nodes:
            raise GraphError(f"duplicate node name {node.name!r}")
        for dep in node.inputs:
            if dep not in self.nodes:
                raise GraphError(
                    f"node {node.name!r} references unknown input {dep!r}")
        self.nodes[node.name] = node
        self._tail = node.name
        return node.name

    def _name(self, op: str, name: str | None) -> str:
        if name is not None:
            return name
        self._counter += 1
        return f"{op}{self._counter}"

    def conv(self, weights, bn: dict | None = None, *, stride=(1, 1),
             padding: bool = True, pool=None, delta_ratio: float = 0.7,
             after: str | None = None, name: str | None = None) -> str:
        """Append a conv node (weights (K, K, Cin, Cout), float or trits)."""
        return self._register(Node(
            op="conv", name=self._name("conv", name),
            inputs=(after or self._tail,), weights=weights, bn=dict(bn or {}),
            stride=(int(stride[0]), int(stride[1])), padding=bool(padding),
            pool=tuple(pool) if pool is not None else None,
            delta_ratio=delta_ratio))

    def dense(self, weights, bn: dict | None = None, *,
              delta_ratio: float = 0.7, after: str | None = None,
              name: str | None = None) -> str:
        """Append a dense node (weights (D_in, D_out)) over the flattened
        (H, W, C) producer feature map."""
        return self._register(Node(
            op="dense", name=self._name("dense", name),
            inputs=(after or self._tail,), weights=weights, bn=dict(bn or {}),
            delta_ratio=delta_ratio))

    def pool(self, kind: str, window: int, *, after: str | None = None,
             name: str | None = None) -> str:
        """Append a standalone pooling node (max | avg over trits)."""
        return self._register(Node(
            op="pool", name=self._name("pool", name),
            inputs=(after or self._tail,), pool=(kind, int(window))))

    def add(self, a: str, b: str, bn: dict | None = None, *,
            name: str | None = None) -> str:
        """Append a residual add node: ternarize(BN(a + b))."""
        return self._register(Node(
            op="add", name=self._name("add", name), inputs=(a, b),
            bn=dict(bn or {})))

    def set_output(self, name: str) -> None:
        if name not in self.nodes:
            raise GraphError(f"unknown output node {name!r}")
        self._tail = name

    # -- introspection ------------------------------------------------------

    @property
    def output(self) -> str:
        return self._tail

    def __len__(self) -> int:
        return len(self.nodes) - 1          # input node is free

    def index(self, name: str) -> int:
        return list(self.nodes).index(name)

    def consumers(self, name: str) -> list[str]:
        return [n.name for n in self.nodes.values() if name in n.inputs]

    def copy(self) -> "Graph":
        g = Graph(self.in_channels, self.in_hw)
        g.nodes = {k: dataclasses.replace(v) for k, v in self.nodes.items()}
        g._tail = self._tail
        g._counter = self._counter
        return g

    # -- shape inference ----------------------------------------------------

    def out_channels(self, name: str) -> int:
        return self.infer_shapes()[name][2]

    def infer_shapes(self) -> dict[str, tuple[int, int, int]]:
        """Per-node output (H, W, C); raises GraphError on inconsistency."""
        shapes: dict[str, tuple[int, int, int]] = {
            self.INPUT: (self.in_hw[0], self.in_hw[1], self.in_channels)}
        for idx, node in enumerate(self.nodes.values()):
            if node.op == "input":
                continue
            try:
                ins = [shapes[i] for i in node.inputs]
            except KeyError as e:
                raise _err(node, idx, f"input {e} has no inferred shape "
                           "(nodes must be added producers-first)") from None
            shapes[node.name] = self._node_shape(node, idx, ins)
        return shapes

    def _node_shape(self, node: Node, idx: int, ins) -> tuple[int, int, int]:
        if node.op == "conv":
            w = np.shape(node.weights)
            if len(w) != 4 or w[0] != w[1]:
                raise _err(node, idx,
                           f"weights: expected (K, K, Cin, Cout), got {w}")
            h, wd, c = ins[0]
            if w[2] != c:
                raise _err(node, idx, f"weights: Cin {w[2]} != producer "
                           f"channels {c}")
            k = w[0]
            if not node.padding and (h < k or wd < k):
                raise _err(node, idx, f"padding=False conv kernel {k} "
                           f"does not fit {h}x{wd} feature map")
            oh, ow = engine.conv_out_dims(k, node.stride, node.padding,
                                          h, wd)
            if node.pool is not None:
                oh, ow = self._pooled(node, idx, (oh, ow))
            return (oh, ow, w[3])
        if node.op == "pool":
            h, wd, c = ins[0]
            oh, ow = self._pooled(node, idx, (h, wd))
            return (oh, ow, c)
        if node.op == "dense":
            w = np.shape(node.weights)
            h, wd, c = ins[0]
            if len(w) != 2:
                raise _err(node, idx,
                           f"weights: expected (D_in, D_out), got {w}")
            if w[0] != h * wd * c:
                raise _err(node, idx, f"weights: D_in {w[0]} != flattened "
                           f"producer {h}x{wd}x{c} = {h * wd * c}")
            return (1, 1, w[1])
        if node.op == "add":
            if ins[0] != ins[1]:
                raise _err(node, idx, f"operand shapes differ: {ins[0]} vs "
                           f"{ins[1]}")
            return ins[0]
        raise _err(node, idx, f"unknown op {node.op!r}")

    def _pooled(self, node: Node, idx: int, hw) -> tuple[int, int]:
        kind, win = node.pool
        if kind not in ("max", "avg"):
            raise _err(node, idx, f"pool: kind {kind!r} not in (max, avg)")
        if win < 2 or hw[0] < win or hw[1] < win:
            raise _err(node, idx,
                       f"pool: window {win} invalid for {hw[0]}x{hw[1]}")
        return hw[0] // win, hw[1] // win
