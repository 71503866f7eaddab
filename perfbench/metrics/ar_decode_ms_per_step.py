"""Host time of ``predict_many`` (encode and decode, synchronised by its
host copy of the mels) over the decode steps its batches ran, in ms."""


def read(ctx):
    if not ctx.get("decode_steps"):
        return None
    return ctx["predict_s"] / ctx["decode_steps"] * 1e3
