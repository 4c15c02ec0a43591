"""The program's model built from the benchmark's weights: the port's
``LM`` made on the meta device (nothing drawn), each parameter then
replaced by the view of the flat buffer `bench/weights.py` drew under
its name, or by a copy of it."""

from __future__ import annotations


def install(torch, model, views: dict, copy: bool):
    """Put ``views[name]`` (or a copy) in place of every parameter of
    ``model``; the names and shapes must match the layout exactly."""
    from torch import nn
    seen = set()
    for prefix, mod in model.named_modules():
        for attr, p in list(mod.named_parameters(recurse=False)):
            name = f"{prefix}.{attr}" if prefix else attr
            if name not in views or tuple(views[name].shape) != \
                    tuple(p.shape):
                raise ValueError(f"the program's parameter {name} "
                                 f"{tuple(p.shape)} is not in the layout")
            t = views[name].clone() if copy else views[name]
            setattr(mod, attr, nn.Parameter(t, requires_grad=False))
            seen.add(name)
    missing = set(views) - seen
    if missing:
        raise ValueError(f"the program has no parameters {sorted(missing)}")
    return model


def build(torch, run, copy: bool):
    """(the port's model of the cell's configuration holding the weights
    drawn from ``run.seed``, its configuration)."""
    from bench.weights import dense_layout, draw
    from repro_torch.models.transformer import init_model
    cfg = run.port_config()
    model = init_model(cfg, None, torch.float32, "meta")
    flat, views = draw(torch, dense_layout(run.model), run.seed, run.device)
    install(torch, model, views, copy)
    del flat, views
    run.sync()
    run.phase("weights drawn and installed")
    return model, cfg


def reference_weights(torch, run):
    """The same weights drawn again for the reference: (flat, views)."""
    from bench.weights import dense_layout, draw
    return draw(torch, dense_layout(run.model), run.seed, run.device)
