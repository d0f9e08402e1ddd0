"""Static trace verification example (graph & trace verifier subsystem).

Exports a small pipelined training trace, then deliberately corrupts it
the way real export/feeder bugs do — drops a COMM_RECV_NODE (its peer
rank would deadlock), duplicates a node id, and adds a back-edge to the
control-dep chain — and shows the verifier catching each fault with a
stable diagnostic code:

    STG101  Send/Recv without a matching peer
    STG301  duplicate node id in a rank trace
    STG303  cycle in the data/control dependency graph
    STG308  stale file the export manifest does not list

The same checks run in-memory (no files) via ``trace.verify()`` and
``job.verify()``, and from the command line:

    python -m repro_torch.analysis <trace_dir>

    PYTHONPATH=src python examples_torch/verify_trace.py
"""
import json
import os
import tempfile

from repro_torch import ModelSpec, Scenario
from repro_torch.analysis import check_trace_dir

spec = ModelSpec(name="demo-2b", n_layers=8, d_model=2048, n_heads=16,
                 n_kv_heads=8, d_ff=5504, vocab=32000)
sc = Scenario(spec).train(batch=8, seq=512).parallel(
    dp=2, pp=2, microbatches=4, schedule="1f1b")
trace = sc.trace()

# in-memory verify: graph lint + comm checks + schedule checks
report = trace.verify(include_graph=True)
print(report.render())

out = tempfile.mkdtemp(prefix="stage_trace_")
trace.export_chakra(out, expand_microbatches=True)
print(f"\nexported {len(os.listdir(out))} files -> {out}")
print(check_trace_dir(out).render())

# ---- now corrupt rank1's trace the way export bugs would ----------------
fp = os.path.join(out, "rank1.json")
with open(fp) as f:
    tr = json.load(f)
nodes = tr["nodes"]
recv = next(n for n in nodes if n["type"] == "COMM_RECV_NODE")
nodes.remove(recv)                        # dropped recv -> peer deadlocks
nodes[1]["id"] = nodes[0]["id"]           # duplicate node id
nodes[2]["ctrl_deps"] = [nodes[-1]["id"]]  # back-edge -> ctrl-dep cycle
with open(fp, "w") as f:
    json.dump(tr, f)
# and leave a file behind that the export manifest never listed
with open(os.path.join(out, "rank99.json"), "w") as f:
    json.dump({"schema": "Chakra-json-v0.0.4", "rank": 99, "nodes": []}, f)

print("\nafter corrupting rank1.json (and planting stale rank99.json):")
bad = check_trace_dir(out)
print(bad.render())
assert not bad.ok
assert {"STG101", "STG301", "STG303", "STG308"} <= bad.codes()
