"""Known-bad graph outputs: a name that holds a captured graph's output
read after a later replay rewrote it. One of each form: the output of
capture_graph, a view of an engine's output, and a `with torch.cuda.graph`
body's output."""

import torch


def capture_graph(program, device):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = program()
    return graph, out


def replay_all(program, device, static_in, batches):
    graph, out = capture_graph(program, device)
    results = []
    for batch in batches:
        static_in.copy_(batch)
        graph.replay()
        results.append(out)  # every entry is the one output tensor
    return results


class Engine:
    def __init__(self, program, device):
        self.graph, self.out = capture_graph(program, device)

    def delta(self, static_in, a, b):
        static_in.copy_(a)
        self.graph.replay()
        first = self.out[0]  # a view, not a copy
        static_in.copy_(b)
        self.graph.replay()
        return self.out[0] - first  # `first` is now the second replay's answer


def with_body(model, static_in, batches):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = model(static_in)
    seen = []
    for batch in batches:
        static_in.copy_(batch)
        graph.replay()
        seen.append(y)
    return seen
