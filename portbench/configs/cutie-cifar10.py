"""cutie-cifar10 on the port: the seeded float network compiled by
``CutiePipeline.compile`` onto the configuration's backend, and the
timed call: ``encode_image_ternary`` then ``CutiePipeline.run``."""

from __future__ import annotations

import torch

from portbench import weights


class Program:
    """``program(images)`` -> (N, n_classes) int8 class trits on the
    device, enqueued on the current stream."""

    def __init__(self, sizes: dict, seed: int, device):
        from repro_torch import compiler
        from repro_torch.core import engine, thermometer
        from repro_torch.pipeline import CutiePipeline

        self.sizes = sizes
        self._encode = thermometer.encode_image_ternary
        layers, head = weights.cnn_network(sizes, seed, device)
        hw = sizes["img_hw"]
        g = compiler.Graph(in_channels=sizes["in_channels"], in_hw=(hw, hw))
        for w, bn, pool in layers:
            g.conv(w, dict(bn, eps=sizes["bn_eps"]),
                   pool=None if pool is None else tuple(pool),
                   delta_ratio=sizes["delta_ratio"])
        g.dense(head, delta_ratio=sizes["delta_ratio"])
        self.pipe = CutiePipeline.compile(
            g, instance=engine.CutieInstance(n_layers=sizes["fifo_layers"]),
            backend=sizes["backend"], device=device)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        x = self._encode(images, self.sizes["thermometer_m"])
        return self.pipe.run(x).reshape(images.shape[0], -1)


def build(sizes: dict, traffic: dict, seed: int, device) -> Program:
    return Program(sizes, seed, device)
