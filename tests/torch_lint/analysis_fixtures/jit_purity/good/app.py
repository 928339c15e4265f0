"""Known-good captured bodies: every host read happens before capture or
around a replay, never inside the captured program."""

import os
import time

import torch


def capture_graph(program, device):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = program()
    return graph, out


def _scaled(x, scale):
    return x * scale


class Bucket:
    def __init__(self, x, device):
        self.x = x
        scale = float(os.environ.get("SCALE", "1"))  # read once, outside the capture

        def program():
            return _scaled(self.x, scale).sum()

        self.graph, self.out = capture_graph(program, device)

    def run(self):
        t0 = time.perf_counter()
        self.graph.replay()
        total = self.out.item()  # after the replay, outside the capture
        return total, time.perf_counter() - t0


def capture_plain(x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x * 2.0
    return graph, y
