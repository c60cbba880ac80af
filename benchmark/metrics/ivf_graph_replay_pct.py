"""Share of the profiled sub-window's IVF batches that replayed a CUDA
graph, %: `IvfEngine.search_many_device.traced_replays` over its
`traced_batches`, which the program adds to only while a profiler
records. Nothing without a profiled sub-window, or where the program
keeps no such counter."""


def read(ctx, log):
    if ctx.get("profile") is None:
        log("ivf_graph_replay_pct: no profiled sub-window")
        return None
    from leann_tpu_torch.ops import ivf

    many = getattr(getattr(ivf, "IvfEngine", None), "search_many_device",
                   None)
    batches = getattr(many, "traced_batches", None)
    replays = getattr(many, "traced_replays", None)
    if batches is None or replays is None:
        log("ivf_graph_replay_pct: the program counts no graph replays")
        return None
    if not batches:
        log("ivf_graph_replay_pct: no IVF batch was traced")
        return None
    log(f"{replays} of {batches} traced IVF batches replayed a CUDA graph")
    return 100.0 * replays / batches
