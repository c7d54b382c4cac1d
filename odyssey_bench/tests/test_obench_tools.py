"""The tool that fixed a configuration's ``cap``, run small on the CPU."""
import json

from odyssey_bench import capacity


def test_capacity_reports_the_largest_shard_relation(capsys):
    capacity.main(["--config", "fedbench-ls", "--traffic", "ls-queries.closed",
                   "--seeds", "5", "--cap", "4096", "--device", "cpu", "--scale", "0.001",
                   "--object-hub", "16"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    per_seed, total = lines[0], lines[-1]
    assert per_seed["overflowed"] == 0 and per_seed["queries"] > 100
    need = max(total["worst"].values())
    assert 0 < need <= total["smallest_power_of_two"] < 2 * need
    assert per_seed["top"][0][1] == need
