"""bench.py helpers: a failed row's error must embed cleanly in the
one-line JSON result."""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench  # noqa: E402


def test_err_s_strips_control_and_truncates():
    raw = ("INTERNAL: http://x/remote_compile: HTTP 500\n"
           "\x1b[2m2026-08-20T20:48:41Z\x1b[0m \x1b[33mWARN\x1b[0m "
           "compile-helper: landlock — env" + "x" * 500)
    s = bench.err_s(Exception(raw))
    assert len(s) <= 120
    assert "\n" not in s and "\x1b" not in s
    assert all(32 <= ord(ch) < 127 for ch in s)
    assert s.startswith("INTERNAL: http://x/remote_compile")
    # the sanitized string embeds cleanly in a one-line JSON artifact
    line = json.dumps({"e": s})
    assert "\n" not in line
    assert json.loads(line)["e"] == s

