"""The work of the traced window, counted from shapes at the published
peak of the precision each part computes in (bf16 for the sample loop,
float32 without TF32 for the models), over the traced window, in %."""


def read(ctx):
    if not ctx.get("peak_s"):
        return None
    return 100.0 * ctx["peak_s"] / ctx["trace"]["window_s"]
