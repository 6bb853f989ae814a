"""Host milliseconds from a train step's call to its return, the mean over
the window's steps (rank 0): the captured step's host work (the optimizer's
scalars, the input copies, the replay's launch)."""


def read(ctx):
    return ctx.get("issue_ms")
