"""The port's overlap dispatch region and the host tier's demote staging
wait for nothing on the device.

``tpu_task_torch/ml/serving/engine.py`` marks the code that runs while the
previous program executes (planning, block reservation and the dispatch of
the next program) between two comments, and the host tier's demote pass
(``_demote_pass``, which stages blocks behind the program just
dispatched) between two more; ``cache.py``'s ``BlockStaging`` constructor
and ``write_block_payloads`` (a promotion's upload, run at admission with
a program in flight) are held to the same rules. One wait there
serializes the overlapped loop without any error, so this walks their
syntax trees and fails on what would wait: a readback (``.cpu()``, ``.item()``,
``.numpy()``, ``.tolist()``), any ``.synchronize()`` (a stream, an event,
``torch.cuda.synchronize``), ``torch.tensor`` on a device,
``torch.as_tensor`` or ``.to`` aimed at a device without
``non_blocking=True``, and ``int``/``float``/``bool`` or
``np.asarray``/``np.array`` of a value the region got from ``torch`` or
from the port's programs. The region's callees are held on the card
instead, under ``torch.cuda.set_sync_debug_mode("error")``
(``tests/test_torch_cuda_kernels.py``)."""

import ast
import pathlib
import textwrap

import pytest

SERVING = pathlib.Path(__file__).resolve().parents[1] / \
    "tpu_task_torch/ml/serving"
ENGINE = SERVING / "engine.py"
BEGIN = "# overlap: begin-dispatch-region"
END = "# overlap: end-dispatch-region"
TIER_BEGIN = "# tier: begin-migrate"
TIER_END = "# tier: end-migrate"

READBACKS = {"cpu", "item", "numpy", "tolist", "synchronize"}
#: Calls in the region that return device values: ``torch.*`` and these.
DEVICE_CALLS = {"upload", "_upload", "chunk_carry_greedy",
                "chunk_carry_sample", "dispatch", "_model_params"}
DTYPES = {"bool", "uint8", "int8", "int16", "int32", "int64", "float16",
          "bfloat16", "float32", "float64", "long", "int", "float"}


def _region(source: str, begin: str = BEGIN, end: str = END) -> str:
    lines = source.splitlines()
    starts = [i for i, line in enumerate(lines) if line.strip() == begin]
    ends = [i for i, line in enumerate(lines) if line.strip() == end]
    assert len(starts) == len(ends) == 1, f"one region marked {begin!r}"
    return textwrap.dedent("\n".join(lines[starts[0] + 1:ends[0]]))


def _name(node) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _mentions(node, names) -> bool:
    return any(isinstance(n, ast.Name) and n.id in names
               for n in ast.walk(node))


def _non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and isinstance(kw.value,
                                                        ast.Constant)
               and kw.value.value is True for kw in call.keywords)


def _is_dtype(node) -> bool:
    return (isinstance(node, ast.Attribute) and _name(node.value) == "torch"
            and node.attr in DTYPES)


def _device_names(fn) -> set:
    """Names a function binds from ``torch`` or from a device call, and
    what it derives from them."""
    names = set()
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)) \
                    or node.value is None:
                continue
            value = node.value
            device = _mentions(value, names | {"torch"}) or any(
                isinstance(n, ast.Call) and _name(n.func) in DEVICE_CALLS
                for n in ast.walk(value))
            if not device:
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for target in targets:
                for n in ast.walk(target):
                    if isinstance(n, ast.Name) and n.id not in names:
                        names.add(n.id)
                        changed = True
    return names


def violations(source: str) -> list:
    """(line, what) for every wait in ``source``'s functions."""
    out = []
    tree = ast.parse(source)
    for fn in [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        device = _device_names(fn)
        for call in [n for n in ast.walk(fn) if isinstance(n, ast.Call)]:
            name = _name(call.func)
            owner = (_name(call.func.value)
                     if isinstance(call.func, ast.Attribute) else "")
            if isinstance(call.func, ast.Attribute) and name in READBACKS:
                out.append((call.lineno, f".{name}()"))
            elif owner == "torch" and name == "tensor" and any(
                    kw.arg == "device" for kw in call.keywords):
                out.append((call.lineno, "torch.tensor on a device"))
            elif owner == "torch" and name == "as_tensor" and any(
                    kw.arg == "device" for kw in call.keywords) \
                    and not _non_blocking(call):
                out.append((call.lineno, "blocking torch.as_tensor"))
            elif isinstance(call.func, ast.Attribute) and name == "to" \
                    and not _non_blocking(call) and (
                        any(kw.arg == "device" for kw in call.keywords)
                        or any(not _is_dtype(a) for a in call.args)):
                out.append((call.lineno, "blocking .to(device)"))
            elif isinstance(call.func, ast.Name) \
                    and name in ("int", "float", "bool") and call.args \
                    and _mentions(call.args[0], device | {"torch"}):
                out.append((call.lineno, f"{name}() of a tensor"))
            elif owner == "np" and name in ("asarray", "array") \
                    and call.args \
                    and _mentions(call.args[0], device | {"torch"}):
                out.append((call.lineno, f"np.{name}() of a tensor"))
    return out


def test_engine_dispatch_region_waits_for_nothing():
    region = _region(ENGINE.read_text())
    tree = ast.parse(region)
    defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"_plan_step", "_reserve_planned", "_dispatch_next",
            "_dispatch_micro", "_dispatch_chunk"} <= defined
    assert violations(region) == []


def test_engine_tier_migrate_region_waits_for_nothing():
    region = _region(ENGINE.read_text(), TIER_BEGIN, TIER_END)
    tree = ast.parse(region)
    defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert defined == {"_demote_pass"}
    assert violations(region) == []


def test_tier_staging_and_promotion_upload_wait_for_nothing():
    """The device half of a demote pass (``BlockStaging.__init__``) and of
    a promotion (``write_block_payloads``), walked by the same rules; the
    force (``BlockStaging.payload``) is where the wait belongs."""
    source = (SERVING / "cache.py").read_text()
    tree = ast.parse(source)
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "BlockStaging":
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef):
                    found[f"BlockStaging.{fn.name}"] = fn
        elif isinstance(node, ast.FunctionDef) \
                and node.name == "write_block_payloads":
            found[node.name] = node
    assert {"BlockStaging.__init__", "BlockStaging.payload",
            "write_block_payloads"} <= set(found)
    for name in ("BlockStaging.__init__", "write_block_payloads"):
        fn = found[name]
        assert violations(ast.get_source_segment(source, fn)) == [], name
    waits = violations(ast.get_source_segment(
        source, found["BlockStaging.payload"]))
    assert {what for _, what in waits} == {".synchronize()", ".numpy()"}


BAD = '''
def dispatch(self, widths):
    t = torch.as_tensor(widths, device=self.device)
    n = int(t.sum())
    host = t.cpu()
    z = torch.tensor([1, 2], device="cuda")
    y = t.to(self.device)
    ev.synchronize()
    torch.cuda.synchronize()
    done = bool(t.any())
    arr = np.asarray(t)
    k = t.max().item()
    return n, host, z, y, done, arr, k
'''

GOOD = '''
def dispatch(self, widths, decode):
    t = upload({"w": (widths, torch.int32)}, self.device)["w"]
    u = torch.as_tensor(widths, device=self.device, non_blocking=True)
    v = t.to(torch.int64)
    w = torch.from_numpy(widths).pin_memory().to(self.device,
                                                 non_blocking=True)
    n = int(widths[0]) + int(self._planned_pos[decode[0]])
    m = float(np.asarray(widths).sum())
    return t, u, v, w, n, m
'''


@pytest.mark.parametrize("snippet,expected", [(BAD, 10), (GOOD, 0)],
                         ids=["bad", "good"])
def test_lint_catches_waits_and_passes_non_blocking_code(snippet, expected):
    found = violations(snippet)
    assert len(found) == expected, found
