"""The MIP solve in set-up on the host clock (near 0 when the solve
cache under ``bench/.cache`` serves it)."""

UNIT = "s"


def read(ctx):
    if ctx.e2e != "exec_step_ms":
        return None
    return ctx.spans.get("solve_s")
