"""The JAX package's dry-run values that ``tests/test_torch_dryrun.py``
holds the port's against, written as one JSON file:

    JAX_PLATFORMS=cpu PYTHONPATH=src \
        python tests/torch_dryrun_reference.py OUT.json

``repro.launch.dryrun`` pins ``XLA_FLAGS`` for 512 placeholder devices when
it is imported, so it is imported first, in a process of its own (never in
a pytest worker).  Nothing is compiled: for the ten archs on the 16x16 and
2x16x16 production meshes, the logical rules, the batch's shapes, dtypes
and specs, the decode caches' specs (the layer-sharding heuristic, the
batch one, and the batch one with the kv-sequence over ``model``: the rule
override ``_cache_seq_axis``), rank 0's argument bytes from ``NamedSharding.shard_shape`` over
``eval_shape``'d parameters, ZeRO-1 optimizer state, batch and cache (the
cache's ``pos`` arrays left out: the port keeps ``pos`` as a Python int),
``model_flops_total`` of ``analyze`` (on a stand-in for the compiled
program), and ``stage_predict`` on H100s at ``train_4k`` and
``decode_32k`` (each Scenario trace takes a second or two)."""
from repro.launch import dryrun  # noqa: I001 -- first: pins XLA_FLAGS

import functools
import json
import math
import sys

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import ARCHS, SHAPES, get
from repro.core.costmodel import H100_HGX
from repro.launch.mesh import data_axes_of, make_production_mesh
from repro.models.common import RuntimeCfg
from repro.parallel.sharding import param_shardings
from repro.train.optimizer import init_opt_state, opt_state_shardings

RT = RuntimeCfg(remat="full")
STAGE_SHAPES = ("train_4k", "decode_32k")


def spec_of(sharding) -> list:
    """A PartitionSpec as a list: each entry None or a list of mesh axes."""
    return [None if e is None else list(e) if isinstance(e, tuple) else [e]
            for e in sharding.spec]


def path_of(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def local_bytes(tree, shardings) -> int:
    return sum(math.prod(sh.shard_shape(x.shape)) * x.dtype.itemsize
               for x, sh in zip(jax.tree.leaves(tree),
                                jax.tree.leaves(shardings)))


class Compiled:
    """What ``analyze`` reads of a compiled program, empty: its record then
    holds what does not depend on the program (``model_flops_total``)."""

    def cost_analysis(self):
        return {}

    def memory_analysis(self):
        return None

    def as_text(self):
        return ""


def main(out_path: str) -> None:
    dryrun.preflight = functools.partial(dryrun.preflight, hw=H100_HGX)
    meshes = {("2x16x16" if mp else "16x16"): make_production_mesh(
        multi_pod=mp) for mp in (False, True)}
    out: dict = {tag: {} for tag in meshes}
    for name in ARCHS:
        arch = get(name)
        # the abstract trees do not depend on the mesh
        params = dryrun.abstract_params(arch, RT)
        opt = jax.eval_shape(lambda: init_opt_state(params))
        caches = {s: dryrun._cache_abstract(arch, RT, shape.global_batch,
                                            shape.seq_len)
                  for s, shape in SHAPES.items() if shape.kind == "decode"}
        for tag, mesh in meshes.items():
            da = data_axes_of(mesh)
            deg = math.prod(mesh.shape[a] for a in da)
            rules = dryrun.arch_rules(arch, mesh)
            rec = out[tag][name] = {
                "rules": {k: list(v) if isinstance(v, tuple) else v
                          for k, v in rules.items()},
                "fsdp": rules.get("embed") == da, "shapes": {}}
            p_shard = param_shardings(params, rules, mesh)
            for shape_name, shape in SHAPES.items():
                sds, shd = dryrun.batch_specs(arch, shape, mesh)
                cell = rec["shapes"][shape_name] = {
                    "batch": {k: {"shape": list(sds[k].shape),
                                  "dtype": str(sds[k].dtype),
                                  "spec": spec_of(shd[k])} for k in sds}}
                if shape.kind == "train":
                    o_shard = opt_state_shardings(params, rules, mesh,
                                                  zero1=RT.zero1,
                                                  data_axes=da)
                    args = local_bytes(params, p_shard) \
                        + local_bytes(opt, o_shard) + local_bytes(sds, shd)
                elif shape.kind == "prefill":
                    sds.pop("labels")
                    shd.pop("labels")
                    args = local_bytes(params, p_shard) \
                        + local_bytes(sds, shd)
                else:
                    b = shape.global_batch
                    cache = caches[shape_name]
                    specs = {}
                    for buggy in (True, False):
                        c_shard = dryrun._cache_shardings(cache, mesh,
                                                          batch=b,
                                                          buggy=buggy)
                        specs["buggy" if buggy else "fixed"] = {
                            path_of(p): spec_of(s) for p, s in
                            jax.tree_util.tree_flatten_with_path(c_shard)[0]
                            if not path_of(p).endswith("pos")}
                    cell["cache"] = specs
                    tok = jax.ShapeDtypeStruct((b, 1), jnp.int32)
                    t_shard = NamedSharding(mesh, P(da) if b % deg == 0
                                            else P())

                    def decode_args(c_shard):
                        keep = [(x, s) for (p, x), s in zip(
                            jax.tree_util.tree_flatten_with_path(cache)[0],
                            jax.tree.leaves(c_shard))
                            if not path_of(p).endswith("pos")]
                        return local_bytes(params, p_shard) \
                            + local_bytes([x for x, _ in keep],
                                          [s for _, s in keep]) \
                            + local_bytes(tok, t_shard)
                    args = decode_args(dryrun._cache_shardings(
                        cache, mesh, batch=b, buggy=True))
                    # the m2 variant: _buggy_cache False, _cache_seq_axis
                    # "model" (lower_cell's rule overrides)
                    seq = dryrun._cache_shardings(cache, mesh, batch=b,
                                                  seq_axis="model",
                                                  buggy=False)
                    cell["cache_seq"] = {
                        path_of(p): spec_of(s) for p, s in
                        jax.tree_util.tree_flatten_with_path(seq)[0]
                        if not path_of(p).endswith("pos")}
                    cell["seq_args_bytes"] = decode_args(seq)
                cell["args_bytes"] = args
                if shape_name in arch.skip:
                    continue
                record = dryrun.analyze(arch, shape_name, Compiled(), mesh,
                                        wall_s=0.0)
                for key in ("model_flops_total", "chips", "mesh"):
                    cell[key] = record[key]
                if shape_name in STAGE_SHAPES:
                    cell["stage_predict"] = dryrun.stage_predict(
                        arch, shape_name, multi_pod=tag == "2x16x16",
                        fsdp=rec["fsdp"], zero1=RT.zero1)
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
