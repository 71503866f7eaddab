"""Host time of ``generate_many`` (conditioning, fold, the sample loop B1,
unfold and finalize, and the copy of the waveforms to the host) a batch."""


def read(ctx):
    if not ctx.get("batches"):
        return None
    return ctx["generate_s"] / ctx["batches"]
