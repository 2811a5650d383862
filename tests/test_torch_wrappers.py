"""The port's workflow wrappers, scripts/torch_run_*.sh, against the JAX
package's scripts/run_*.sh: the same environment variables with the same
defaults and the same flags, on thermal3d_torch's CLIs; the four that pass
their arguments on reach their CLI's parser; the preprocessing smoke test
wants its image. (The train and evaluate wrappers also run on tiny trees,
in tests/test_torch_train_data.py and tests/test_torch_files.py, where
their files are held to a direct call of the CLI.)"""

import re
from pathlib import Path

import pytest

from tests.test_torch_common import run_wrapper

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
# wrapper → the port CLI it runs with "$@" passed on
PASSING_ON = {
    "torch_run_train_thermal_dustr.sh": "train",
    "torch_run_generate_pseudo_gt.sh": "pseudo_gt",
    "torch_run_evaluate_thermal_dustr.sh": "evaluate",
    "torch_run_grid_search_thermal_parameters.sh": "grid_search",
}
WRAPPERS = [*PASSING_ON, "torch_run_test_preprocessing.sh"]
DEFAULT = re.compile(r'^(\w+)="\$\{\1:-(.*)\}"$', re.MULTILINE)


def _command(text: str, module: str):
    """The flags of the `python -m <package>.cli.<module>` command, one
    string a flag and its values, continuation lines joined."""
    line = re.search(rf"python -m \w+\.cli\.{module}\b(.*?)(?:\n\S|\Z)",
                     text.replace("\\\n", " "), re.DOTALL).group(1)
    return line.split()


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_wrapper_keeps_the_reference_defaults(wrapper):
    """Each wrapper sets the environment variables of its JAX counterpart,
    with the same defaults, and runs the same command with the same flags
    on the port's CLI (thermal3d_torch.cli.<name>)."""
    ours = (SCRIPTS / wrapper).read_text()
    ref = (SCRIPTS / wrapper.removeprefix("torch_")).read_text()
    assert DEFAULT.findall(ours) == DEFAULT.findall(ref)
    module = PASSING_ON.get(wrapper, "infer")
    assert f"python -m thermal3d_torch.cli.{module} " in ours
    assert _command(ours, module) == _command(ref, module)
    assert ours.startswith("#!/bin/bash\n") and "set -euo pipefail" in ours


@pytest.mark.parametrize("wrapper", list(PASSING_ON))
def test_wrapper_help_reaches_the_port_cli(wrapper, tmp_path):
    """`--help`, passed on last, stops at the port CLI's parser: exit 0, and
    the usage names the port's module."""
    proc = run_wrapper(wrapper, tmp_path, ["--help"], timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith(
        f"usage: python -m thermal3d_torch.cli.{PASSING_ON[wrapper]} "), proc.stdout[:200]


def test_preprocessing_wrapper_needs_an_image(tmp_path):
    proc = run_wrapper("torch_run_test_preprocessing.sh", tmp_path, timeout=60)
    assert proc.returncode != 0
    assert "usage: torch_run_test_preprocessing.sh <thermal.png> [output_dir]" in proc.stderr
