"""Shared by the capacity configurations' CPU tests (test_torch_capacity.py,
path 10's IVF-BQ flags; test_torch_capacity_opq.py, path 11's IVF-OPQ(r)
flags): the 100M geometry, path 10's flags, and the JAX harness
(tools/bench_10m.py) read from its own source."""

import ast
import pathlib

N_CAP = 100_000_000
NLIST_CAP, S_CAP = 32_552, 1024
NBK_CAP = 114_026  # the JAX run's bucket count (BASELINE.md:578-579)
JAX_HARNESS = pathlib.Path(__file__).resolve().parent.parent / "tools" / "bench_10m.py"
# chip_smoke.py's path 10 (its CAPACITY_ARGV); a later flag wins.
CAPACITY_ARGV = ["--n", "100000000", "--batch", "250000", "--d", "768", "--dist", "realistic",
                 "--normalize", "--only", "none", "--ivf", "--ivf-base", "bq"]
# Path 11's (BASELINE.md:612-622): path 10's with the IVF-OPQ(r) inner codes.
CAPACITY_OPQ_ARGV = CAPACITY_ARGV[:-1] + ["opq", "--ivf-residual"]


def jax_main():
    tree = ast.parse(JAX_HARNESS.read_text(), str(JAX_HARNESS))
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def run_stmts(stmts, ns):
    exec(compile(ast.Module(body=list(stmts), type_ignores=[]), str(JAX_HARNESS), "exec"), ns)
    return ns


def jax_ladder(nbk):
    """The JAX harness's ``ladder`` (a closure over its bucket count),
    compiled from its source with ``nbk`` buckets."""
    fn = next(n for n in ast.walk(jax_main())
              if isinstance(n, ast.FunctionDef) and n.name == "ladder")
    return run_stmts([fn], {"nbk": nbk})["ladder"]


def jax_block_legs(n, nbk, first):
    """(coarse (nprobe, nscan), rescored (R, nprobe, nscan)) of a block of
    the JAX harness's ``main``: its statements from the assignment to
    ``first`` on run from its source, the iterables of its first two loops
    evaluated where they stand."""
    for node in ast.walk(jax_main()):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        for i, st in enumerate(body):
            if (isinstance(st, ast.Assign) and isinstance(st.targets[0], ast.Name)
                    and st.targets[0].id == first):
                ns = {"ladder": jax_ladder(nbk), "N": n}
                lists = []
                for st2 in body[i:]:
                    if not isinstance(st2, ast.For):
                        run_stmts([st2], ns)
                        continue
                    lists.append(list(eval(compile(ast.Expression(st2.iter), str(JAX_HARNESS),
                                                   "eval"), ns)))
                    if len(lists) == 2:
                        return tuple(lists)
    raise AssertionError(f"no {first} in tools/bench_10m.py")
