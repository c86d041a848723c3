"""§Perf hillclimb: count the probes of one cell (or one probe)
under named optimization variants and print the roofline deltas — port
of ``repro.launch.hillclimb``, the fast hypothesis → change → measure
loop.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch olmoe-1b-7b \
      --shape train_4k --variants "base;moe_group"

Variants (the reference's names): ``moe_shard`` (the MoE dispatch
buffers' expert / token axes), ``moe_group`` (group-local dispatch over
dp_size groups), ``seqpar`` (block outputs sharded over the sequence),
``flash_block`` (smaller attention tiles), ``chunkN`` (the SSD chunk),
``kv8`` (the int8 KV cache).  The port counts one program on one device
(``launch.analysis.count`` on fake tensors, per device an ideal
partition over the mesh); it has no partitioner, so ``moe_shard`` and
``seqpar`` are the identity there and change no count.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

from repro_torch.configs import ALIASES, get_config
from repro_torch.launch import analysis, mesh as mesh_lib, specs
from repro_torch.models import layers, moe
from repro_torch.models.config import SHAPES

#: Variants that only name mesh axes: the identity on one device, so
#: :func:`variant_ctx` enters nothing for them.
IDENTITY_HERE = ("moe_shard", "seqpar")


@contextlib.contextmanager
def variant_ctx(names: set[str], mesh):
    """Compose optimization contexts by name."""
    dp = mesh_lib.dp_axes(mesh)
    with contextlib.ExitStack() as stack:
        if "moe_group" in names:
            dp_size = 1
            for a in dp:
                dp_size *= mesh_lib.axis_sizes(mesh)[a]
            stack.enter_context(moe.moe_sharding(
                expert_axis="model", token_axes=dp, groups=dp_size))
        if "flash_block" in names:
            stack.enter_context(layers.attention_override(
                q_block=256, kv_block=512))
        yield


def measure(arch: str, shape: str, variants: set[str], *,
            probe_filter: str | None = None,
            multi_pod: bool = False) -> dict:
    """The probes' composition under ``variants``; per device over the
    mesh's chips."""
    cfg = get_config(arch)
    for v in variants:
        if v.startswith("chunk") and cfg.ssm is not None:
            cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm,
                                                      chunk=int(v[5:])))
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    cell = SHAPES[shape]
    tot = {"flops": 0, "bytes": 0, "coll": 0.0}
    details = []
    attn_probe_cfg = specs._attn_blocks_for(cell.seq_len)
    if "flash_block" in variants:
        attn_probe_cfg = dict(q_block=max(256, cell.seq_len // 16),
                              kv_block=max(512, cell.seq_len // 16))
    with layers.attention_override(**attn_probe_cfg):
        with variant_ctx(variants - {"flash_block"}, mesh):
            for pr in specs.probe_jobs(cfg, shape, mesh,
                                       kv_quant="kv8" in variants):
                if probe_filter and probe_filter not in pr.name:
                    continue
                c = analysis.count(pr.fn, *pr.args)
                tot["flops"] += c.flops * pr.multiplier
                tot["bytes"] += c.bytes * pr.multiplier
                details.append((pr.name, pr.multiplier, c))
    roof = analysis.roofline(tot["flops"] / chips, tot["bytes"] / chips)
    return {"t_compute": roof.t_compute, "t_memory": roof.t_memory,
            "t_collective": roof.t_collective, "t_bound": roof.t_bound,
            "bottleneck": roof.bottleneck, "details": details, **tot}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=sorted(ALIASES))
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--variants", default="base",
                    help="variant sets separated by ';', each a '+' list, "
                         "e.g. 'base;moe_shard;moe_shard+seqpar'")
    ap.add_argument("--probe", default=None, help="probe-name filter")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    records = []
    for vs in args.variants.split(";"):
        names = set() if vs == "base" else set(vs.split("+"))
        r = measure(args.arch, args.shape, names, probe_filter=args.probe)
        print(f"[{vs:24s}] t_c={r['t_compute']:.3f}s t_m={r['t_memory']:.3f}s "
              f"t_x={r['t_collective']:.3f}s bound={r['bottleneck']} "
              f"t_bound={r['t_bound']:.3f}s", flush=True)
        same = sorted(names & set(IDENTITY_HERE))
        if same:
            print(f"    {', '.join(same)}: the identity on the port's one "
                  "device (no partitioner): no count changes", flush=True)
        for name, mult, c in r["details"]:
            print(f"    {name:26s} x{mult:3d} fl={c.flops:.2e} "
                  f"by={c.bytes:.2e} ops={c.ops}")
        records.append({"arch": args.arch, "shape": args.shape, "variant": vs,
                        **{k: r[k] for k in ("t_compute", "t_memory",
                                             "t_collective", "t_bound",
                                             "bottleneck", "flops", "bytes",
                                             "coll")}})
    if args.out:
        with open(args.out, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    return records


if __name__ == "__main__":
    main()
