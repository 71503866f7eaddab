"""Mean time from a stream's request to its first chunk on the host."""


def read(ctx):
    first = ctx.get("first_gaps")
    if not first:
        return None
    return sum(first) / len(first)
