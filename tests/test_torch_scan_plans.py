"""The walking kernels' host-side plans (kernels/fleet_scan.py,
kernels/sim_scan.py), on the CPU with nothing compiled: which walk an M
selects, how the fleet kernel's shared memory is split between the fixed
regions (staging windows, record ring, edges, histogram), the lane's tables
and the per-replica FIFOs against MAX_SMEM_BYTES, the simulator's table
sizing, and the refusals above the limit.  The card tests hold the C
layouts equal to these mirrors (test_scan_kernels_lay_out_the_wrappers_plans)."""
import pytest
import torch

from repro_torch.kernels import fleet_scan as fk
from repro_torch.kernels import sim_scan as sk


@pytest.mark.parametrize("M,walk", [(1, "registers"), (8, "registers"), (9, "shared"),
                                    (fk.MAX_REPLICAS, "shared")])
def test_fleet_walk_by_replicas(M, walk):
    assert fk.REG_REPLICAS == 8
    assert fk.smem_plan(100, M, 2, 129, 1000, 16, False).walk == walk


def test_fleet_plan_keeps_the_path_runs_on_chip():
    """chip_smoke's one-lane run (M = 3, 8000 arrivals plus padding): the
    tables and the 96 KB of FIFOs both fit; the grid's 20 000-arrival
    traces at M = 4 keep their FIFOs in global scratch."""
    one = fk.smem_plan(129, 3, 1, 25, 8064, 16, False)
    assert one.stage_tables and one.fifo_smem
    assert 3 * 8064 * 4 < one.bytes <= fk.MAX_SMEM_BYTES
    grid = fk.smem_plan(129, 4, 1, 129, 20_064, 32, False)
    assert grid.stage_tables and not grid.fifo_smem and grid.bytes <= fk.MAX_SMEM_BYTES


def test_fleet_plan_regions():
    """Each region is 16-byte aligned after 64 bytes of counters; the
    tables add 16 M K L bytes, the FIFO 4 M size, a mix lane its staged
    belief rows (two chunks of 256 rows of K doubles)."""
    args = (10, 3, 2, 7, 50, 9)
    base = fk.smem_bytes(*args, False, False, False)
    assert base % 16 == 0
    assert fk.smem_bytes(*args, False, True, False) - base == 16 * 3 * 2 * 7
    assert fk.smem_bytes(*args, False, False, True) - base == 4 * 3 * 50 + 8
    assert fk.smem_bytes(*args, True, False, False) - base == 8 * 2 * 256 * 2


def test_fleet_plan_drops_fifo_then_tables():
    n_edges, K, L, b_max = 129, 1, 129, 16
    small = fk.smem_plan(n_edges, 4, K, L, 1000, b_max, False)
    assert small.stage_tables and small.fifo_smem
    big_fifo = fk.smem_plan(n_edges, 4, K, L, 60_000, b_max, False)
    assert big_fifo.stage_tables and not big_fifo.fifo_smem
    big_tab = fk.smem_plan(n_edges, 64, 4, 400, 100, b_max, False)
    assert not big_tab.stage_tables and big_tab.fifo_smem
    for plan in (small, big_fifo, big_tab):
        assert plan.bytes <= fk.MAX_SMEM_BYTES
        assert plan.bytes == fk.smem_bytes(n_edges, *((4, K, L, 1000) if plan is small else
                                                      (4, K, L, 60_000) if plan is big_fifo
                                                      else (64, 4, 400, 100)),
                                           b_max + 1, False, plan.stage_tables,
                                           plan.fifo_smem)


def test_fleet_plan_refuses_above_the_limit():
    """Too many histogram edges leave no room even for the fixed regions."""
    with pytest.raises(ValueError, match="use fewer bins"):
        fk.smem_plan(40_000, 4, 1, 129, 100, 16, False)
    assert fk.smem_plan(15_000, 4, 1, 129, 100, 16, False).bytes <= fk.MAX_SMEM_BYTES


def test_fleet_int32_counters():
    """Positions and carried counters are int32 in the kernel: the wrapper
    refuses inputs that could overflow them."""
    state0 = torch.zeros((len(fk.STATE0), 3), dtype=torch.int64)
    fk._check_int32(1, 1000, state0, 10_000)
    with pytest.raises(ValueError, match="below 2"):
        fk._check_int32(2, 2 ** 31 - 2, state0, 10)
    state0[0, 1] = 2 ** 31 - 100
    with pytest.raises(ValueError, match="step_cap"):
        fk._check_int32(1, 1000, state0, 200)


def test_sim_smem_sizing_and_refusal():
    base = sk.smem_bytes(1, 1, 1)
    assert base % 16 == 0
    assert sk.smem_bytes(129, 33, 1) - sk.smem_bytes(1, 33, 1) == (129 * 4 + 15) // 16 * 16 - 16
    assert sk.check_smem(129, 33, 3) == sk.smem_bytes(129, 33, 3) <= sk.MAX_SMEM_BYTES
    assert sk.check_smem(4097, 33, 3) <= sk.MAX_SMEM_BYTES  # solve()'s largest s_max
    with pytest.raises(ValueError, match="shared memory"):
        sk.check_smem(60_000, 33, 3)
    with pytest.raises(ValueError, match="2\\^30"):
        sk.check_smem(129, 33, 3, A=2 ** 30)
    assert sk.check_smem(129, 33, 3, A=10 ** 6, k_max=sk.MAX_K_MAX)
    assert sk.check_smem(129, 33, 3, A=100, k_max=10 ** 9)  # a run never passes A
    with pytest.raises(ValueError, match="k_max"):
        sk.check_smem(129, 33, 3, A=10 ** 6, k_max=sk.MAX_K_MAX + 1)
