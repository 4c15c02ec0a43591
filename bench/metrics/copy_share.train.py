"""The share of the train step's device time in device-to-device copies
(``Memcpy DtoD``)."""

UNIT = "%"


def read(ctx):
    if ctx.e2e != "train_tokens_per_s" or ctx.trace is None:
        return None
    return 100.0 * ctx.trace.device_s(lambda n: n.startswith("Memcpy DtoD")) \
        / ctx.trace.device_s()
