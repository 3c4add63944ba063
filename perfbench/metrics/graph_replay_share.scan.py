"""The share of the batch driver's `analyze` spans in the scan's window
that replayed a captured CUDA graph (the span's `graph` argument is
"replay"; "capture" where a shape's first batch ran eagerly and was
captured), in %. A program whose `analyze` spans say nothing of a graph
gives None."""

from perfbench.program_spans import driver_spans


def read(view):
    if driver_spans(view) is None:
        return None
    dispatches: dict = {}
    for s in view.program_spans:
        if s.name == "batch.dispatch":
            dispatches[s.thread] = dispatches.get(s.thread, 0) + 1
    driver = max(dispatches, key=dispatches.get)
    graphs = [(s.args or {}).get("graph") for s in view.program_spans
              if s.name == "analyze" and s.thread == driver
              and min(s.end_ns, view.t1_ns) > max(s.start_ns, view.t0_ns)]
    if not any(graphs):
        return None
    return 100.0 * graphs.count("replay") / len(graphs)
