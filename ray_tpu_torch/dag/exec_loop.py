"""Resident execution loop run inside each actor of a compiled DAG.

Analog of the reference's do_exec_tasks loop injected into actors by
compiled_dag_node.py: read input channels, run the bound method, write the
result to every consumer channel. A STOP sentinel propagates downstream and
terminates every loop.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ray_tpu_torch.dag.channel import Channel, make_channel

STOP = "__RT_DAG_STOP__"


def dag_exec_loop(actor_instance: Any, spec: Dict[str, Any]) -> int:
    """spec:
    method_name: str
    arg_specs: list of ("const", value) | ("chan", (name, size)) — positional
    kwarg_specs: {key: same}
    out_channels: [(name, size)]  (already created by the driver)
    Returns the number of executed iterations."""
    method = getattr(actor_instance, spec["method_name"])
    in_channels: List[Channel] = []
    arg_fns = []
    for kind, payload in spec["arg_specs"]:
        if kind == "const":
            arg_fns.append(("const", payload))
        else:
            ch = make_channel(payload)
            in_channels.append(ch)
            arg_fns.append(("chan", ch))
    kwarg_fns = {}
    for key, (kind, payload) in spec.get("kwarg_specs", {}).items():
        if kind == "const":
            kwarg_fns[key] = ("const", payload)
        else:
            ch = make_channel(payload)
            in_channels.append(ch)
            kwarg_fns[key] = ("chan", ch)
    outs = [make_channel(sp) for sp in spec["out_channels"]]

    iterations = 0

    def read_one(ch: Channel):
        """-> (value, stop, error). Upstream wire tuples are unwrapped here
        so user methods see raw values; upstream errors skip execution and
        propagate."""
        v = ch.read()
        if isinstance(v, str) and v == STOP:
            return None, True, None
        if isinstance(v, tuple) and len(v) == 2 and v[0] in ("ok", "err"):
            if v[0] == "err":
                return None, False, v[1]
            return v[1], False, None
        return v, False, None

    try:
        while True:
            stop = False
            upstream_err = None
            args = []
            for kind, payload in arg_fns:
                if kind == "const":
                    args.append(payload)
                else:
                    v, s, e = read_one(payload)
                    stop = stop or s
                    upstream_err = upstream_err or e
                    args.append(v)
            kwargs = {}
            for key, (kind, payload) in kwarg_fns.items():
                if kind == "const":
                    kwargs[key] = payload
                else:
                    v, s, e = read_one(payload)
                    stop = stop or s
                    upstream_err = upstream_err or e
                    kwargs[key] = v
            if stop:
                for out in outs:
                    out.write(STOP)
                return iterations
            if upstream_err is not None:
                wire = ("err", upstream_err)
            else:
                try:
                    result = method(*args, **kwargs)
                    wire = ("ok", result)
                except Exception as e:  # propagate downstream instead of dying
                    wire = ("err", e)
            for out in outs:
                out.write(wire)
            iterations += 1
    finally:
        for ch in in_channels:
            ch.close()
        for out in outs:
            out.close()


def unwrap(wire: Any) -> Any:
    """Driver/consumer side: re-raise executor errors."""
    if isinstance(wire, tuple) and len(wire) == 2 and wire[0] in ("ok", "err"):
        if wire[0] == "err":
            raise wire[1]
        return wire[1]
    return wire
