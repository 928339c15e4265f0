"""Known-bad captured bodies: host impurity that capture bakes into every
replay. One of each form: a def nested in the capturing method, a lambda,
a `with torch.cuda.graph` body, and a helper one call deep."""

import os
import time

import numpy as np
import torch

CAPTURES = 0


def capture_graph(program, device):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = program()
    return graph, out


def _scale():
    return float(os.getenv("SCALE", "1"))  # one call deep from `program`


class Bucket:
    def __init__(self, x, device):
        self.x = x

        def program():
            noise = torch.from_numpy(np.random.rand(4))  # drawn once, at capture
            stamp = time.perf_counter()  # read once, at capture
            return self.x * _scale() + noise * stamp

        self.graph, self.out = capture_graph(program, device)
        self.total = capture_graph(lambda: self.x.sum().item(), device)


def capture_counted(x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        global CAPTURES
        CAPTURES += 1
        y = x * float(os.environ["SCALE"])
    return graph, y
