"""``chip_smoke.py`` leaves no process behind: orphans of its children come
to it, and its end stops and reaps every descendant."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# A pod-like child: a new session whose leader starts a sleeper and is then
# SIGKILLed, so the sleeper is orphaned; and a shell that backgrounds a
# sleeper and exits at once. Run in a process of its own, since
# `adopt_orphans` marks the process that calls it for good.
PLANT = """
import os, signal, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs

cs.adopt_orphans()
pod = subprocess.Popen(["sh", "-c", "sleep 300 >/dev/null 2>&1 & echo $!; wait"],
                       start_new_session=True, stdout=subprocess.PIPE, text=True)
orphans = [int(pod.stdout.readline())]
os.kill(pod.pid, signal.SIGKILL)
pod.wait()
shell = subprocess.run(["sh", "-c", "sleep 300 >/dev/null 2>&1 & echo $!"],
                       capture_output=True, text=True)
orphans.append(int(shell.stdout))
time.sleep(0.2)
adopted = sorted(cs._children())
stopped = cs.stop_descendants(timeout=30.0)
gone = [not os.path.exists(f"/proc/{pid}") for pid in orphans]
print(sorted(orphans) == adopted, len(stopped), gone, sorted(cs._children()))
"""


def test_orphaned_descendants_are_adopted_stopped_and_reaped():
    out = subprocess.run([sys.executable, "-c", PLANT, str(ROOT)], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "True 2 [True, True] []", (out.stdout, out.stderr)
    assert out.stderr.count("chip_smoke: stopped a process left running: sleep 300") == 2
