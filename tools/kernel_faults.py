#!/usr/bin/env python3
"""Planted faults in the port's CUDA kernels and in the code around them
(the dataplane kernel's autograd function, the loss's edges, recompute
telemetry, checkpoint restore) and in the verbs transport (a post that
skips mediation, a reversed READ, an unmasked WireFault hash, a snapshot
in another ring layout, rank 0's state kept for every rank);
chip_smoke.py must catch each.

    python3 tools/kernel_faults.py [fault ...]   # on a machine with a card

For each fault (all of them without arguments) it copies
``chip_smoke.py`` and ``src/`` into a temporary directory, makes one
edit to one kernel source or wrapper there, builds the kernels and runs
the phase of ``chip_smoke.py`` that checks that kernel.  A fault is caught when the
phase fails.  One line per fault gives the error the phase reported; the
exit code is nonzero when a fault was missed.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
_FLASH = "kernels/flash_attention/csrc/flash_attention.cu"
_SSM = "kernels/ssm_scan/csrc/ssm_scan.cu"
_BOUNCE = "kernels/dataplane/csrc/bounce.cu"
_STALL = "kernels/dataplane/stall.py"

# name -> (source under src/repro_torch, text, replacement, phase); text
# and replacement may be tuples of as many edits
FAULTS = {
    # O is not rescaled when a row's running max moves
    "flash_no_o_rescale": (
        _FLASH, "        rescale<D>(acc, ca, cb);   // O where m moved\n", "\n",
        "phase_flash"),
    # the producer never fills the ring's last stage: it arrives on the
    # stage's full barrier without a load, so the consumer reads stale K/V
    "flash_ring_last_stage_unfilled": (
        _FLASH, "        mbar_expect_tx(full, 2 * L::kTile);\n",
        "        mbar_expect_tx(full, st == kStages - 1 ? 0 : 2 * L::kTile);\n"
        "        if (st == kStages - 1) continue;\n", "phase_flash"),
    # the K descriptor names the 64-byte swizzle; TMA wrote the 128-byte one
    "flash_k_desc_swizzle_64b": (
        _FLASH, "desc(sK + off, 16, 1024, kSwizzle128)",
        "desc(sK + off, 16, 1024, 2ull << 62)", "phase_flash"),
    # the scan starts from h = 0 instead of h0 (chunk 0 of pass 2)
    "ssm_no_h0": (
        _SSM, "load_row<N>(h, h0 + (bi * di + ch) * N);\n    } else {",
        "for (int n = 0; n < N; ++n) h[n] = 0.f;\n    } else {",
        "phase_ssm"),
    # the scan drops the last time step of the sequence
    "ssm_drop_last_step": (
        _SSM, "#pragma unroll 2\n    for (int i = 0; i < nt; ++i) {\n"
        "      const float d = live ? sm.dt[buf][i][tid] : 0.f;\n"
        "      const float dx = live ? d * sm.x[buf][i][tid] : 0.f;\n"
        "      float p[4]",
        "#pragma unroll 2\n"
        "    for (int i = 0; i < nt - (k == n_chunks - 1 && next >= len);"
        " ++i) {\n"
        "      const float d = live ? sm.dt[buf][i][tid] : 0.f;\n"
        "      const float dx = live ? d * sm.x[buf][i][tid] : 0.f;\n"
        "      float p[4]", "phase_ssm"),
    # the carry is dropped: every chunk k > 0 starts from 0
    "ssm_no_carry": (
        _SSM, "for (int n = 0; n < N; ++n) h[n] = hin[n * di];",
        "for (int n = 0; n < N; ++n) h[n] = 0.f;", "phase_ssm"),
    # a chunk's carried decay leaves out its last step's factor
    "ssm_decay_one_step_short": (
        _SSM, "dec[n] *= f;", "if (t0 + i < len - 1) dec[n] *= f;",
        "phase_ssm"),
    # the scan backward rescans tiles 1 .. T-2 from 0, not their kept state
    "ssm_bwd_kept_state_dropped": (
        _SSM, "                           : ckpt[(static_cast<size_t>(bi) * "
        "(nt - 2) + k - 2) *",
        "                           : 0.0 * ckpt[(static_cast<size_t>(bi) * "
        "(nt - 2) + k - 2) *", "phase_ssm"),
    # the scan backward's d a leaves out the last batch row
    "ssm_bwd_da_drops_a_row": (
        _SSM, "for (int r = 0; r < B; ++r) s += dap[r * din + idx];",
        "for (int r = 0; r < B - 1; ++r) s += dap[r * din + idx];",
        "phase_ssm"),
    # each block skips its last turn of the grid-stride walk over tiles
    "bounce_grid_stride_skip": (
        _BOUNCE, "(p.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x",
        "(p.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x - 1",
        "phase_bounce"),
    # the producer never loads the ring's last stage: it arrives on the
    # stage's full barrier with no bytes, so the storer sends stale bytes
    "bounce_ring_last_stage_unloaded": (
        _BOUNCE,
        "        mbar_expect_tx(smem_u32(&full[s]), "
        "static_cast<uint32_t>(len));\n",
        "        if (s == kStages - 1) {\n"
        "          mbar_arrive(smem_u32(&full[s]));\n"
        "          continue;\n"
        "        }\n"
        "        mbar_expect_tx(smem_u32(&full[s]), "
        "static_cast<uint32_t>(len));\n", "phase_bounce"),
    # the unaligned tail is copied one byte short
    "bounce_tail_drops_last_byte": (
        _BOUNCE, "static_cast<int>(p.tail), copies",
        "static_cast<int>(p.tail) - 1, copies", "phase_bounce"),
    # the delay chain runs one iteration: only the slope check sees it
    "bounce_chain_one_iteration": (
        _BOUNCE, "for (long long i = 0; i < total; ++i)",
        "for (long long i = 0; i < 1; ++i)", "phase_bounce"),
    # the lse is written in base 2: m + log2 l without the factor ln 2
    "flash_lse_base_2": (
        _FLASH,
        "      if (q0 + ra < Sq) lrow[ra] = (m_a + log2f(fmaxf(l_a, 1e-30f))) "
        "* kLn2;\n"
        "      if (q0 + rb < Sq) lrow[rb] = (m_b + log2f(fmaxf(l_b, 1e-30f))) "
        "* kLn2;\n",
        "      if (q0 + ra < Sq) lrow[ra] = m_a + log2f(fmaxf(l_a, 1e-30f));\n"
        "      if (q0 + rb < Sq) lrow[rb] = m_b + log2f(fmaxf(l_b, 1e-30f));\n",
        "phase_train_kernels"),
    # the f32 forward with one TF32 product (hi.hi) where it takes three:
    # the lo terms of Q K^T and P V cut
    "flash_f32_fwd_one_product": (
        _FLASH, ("          mma3(s + 4 * n, qf, kf);   // S = Q K^T\n",
                 "          mma3(acc + 4 * n, pf, vf);   // O += P V\n"),
        ("          mma_tf32(s + 4 * n, qf.hi, kf.hi);\n",
         "          mma_tf32(acc + 4 * n, pf.hi, vf.hi);\n"), "phase_flash"),
    # the f32 backward's dK with one TF32 product: the lo terms of dS^T Q
    # cut
    "flash_f32_bwd_dk_one_product": (
        _FLASH, "mma3(acc_k + 4 * n, df, frag_bp(sq, LD, 8 * kk, c0 + 8 * n, "
        "g, t));",
        "mma_tf32(acc_k + 4 * n, df.hi, frag_bp(sq, LD, 8 * kk, c0 + 8 * n, "
        "g, t).hi);", "phase_quickstart"),
    # the bf16 backward's dK group leaves delta out of dS = P (dP - delta)
    "flash_bwd_no_delta": (
        _FLASH,
        "s[4 * i + u] -= (u & 1) ? d2.y : d2.x;",
        "s[4 * i + u] -= 0.f;", "phase_train_kernels"),
    # the QoS stall reads its trip count once on the host (a stream sync)
    "stall_trip_count_on_host": (
        _STALL, "    iters = iters.to(torch.int32).contiguous()\n",
        "    iters = torch.full((), int(iters.item()), dtype=torch.int32,\n"
        "                       device=x.device)\n", "phase_train_kernels"),
    # the dataplane kernel's autograd function drops the gradient
    "bounce_backward_zeros": (
        "kernels/dataplane/bounce.py",
        "        return g_out, None, None, None\n",
        "        return torch.zeros_like(g_out), None, None, None\n",
        "phase_train_gspmd"),
    # the cross entropy's logits no longer cross the dataplane
    "loss_logits_edge_dropped": (
        "models/losses.py",
        "    logits = constrain(dp, logits, (\"batch\", \"seq\", \"vocab\"),\n"
        "                       tag=\"loss/logits\")\n", "",
        "phase_train_gspmd"),
    # a recomputed forward records its edges again
    "records_kept_in_recompute": (
        "core/dataplane.py", "        if not self._recomputing:\n",
        "        if True:\n", "phase_train_gspmd"),
    # a windowed post skips the sender's mediation (no syscall, no launch)
    "verbs_post_skips_mediation": (
        "core/verbs.py",
        "    wire = _side(dp, \"send\", ps, src, tag, states, tenant)\n",
        "    wire = ps\n", "phase_verbs"),
    # READ's data flows the way a write's does (src to dst)
    "verbs_read_perm_reversed": (
        "core/verbs.py",
        "    a, b = (dst, src) if op == \"read\" else (src, dst)\n",
        "    a, b = (src, dst)\n", "phase_verbs"),
    # the WireFault hash keeps a 64-bit product in its finaliser
    "wirefault_hash_unmasked": (
        "runtime/fault.py", "        h = (h * 0x85ebca6b) & _U32\n",
        "        h = h * 0x85ebca6b\n", "phase_verbs"),
    # a snapshot interleaves the ranks' ring rows
    "snapshot_ring_layout": (
        "core/verbs.py",
        "        return a.reshape((-1,) + a.shape[2:])      # ranks folded "
        "into rows\n",
        "        return a.swapaxes(0, 1).reshape((-1,) + a.shape[2:])\n",
        "phase_verbs"),
    # flush_send's ppermute hands every rank rank 0's state
    "flush_send_keeps_rank0_state": (
        "core/dataplane.py",
        "        return _stack_ranks(done), (states if per_rank else "
        "states[0])\n",
        "        return _stack_ranks(done), ([states[0]] * r if per_rank else "
        "states[0])\n", "phase_verbs"),
    # restore leaves the second moments as the fresh state holds them
    "restore_skips_nu": (
        "checkpoint/store.py", "        out.append(t.to(dev))\n",
        "        out.append(ref if path.startswith(\".opt.nu\") else "
        "t.to(dev))\n", "phase_launcher"),
}


def run(name: str) -> bool:
    src, old, new, phase = FAULTS[name]
    with tempfile.TemporaryDirectory(prefix=f"fault_{name}_") as tmp:
        d = pathlib.Path(tmp)
        shutil.copy(ROOT / "chip_smoke.py", d)
        shutil.copytree(ROOT / "src", d / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = d / "src" / "repro_torch" / src
        text = path.read_text()
        pairs = zip(old, new) if isinstance(old, tuple) else [(old, new)]
        for o, n in pairs:
            if text.count(o) != 1:
                raise SystemExit(f"{name}: the text to replace is not in "
                                 f"{src} exactly once")
            text = text.replace(o, n)
        path.write_text(text)
        r = subprocess.run(
            [sys.executable, "-c",
             f"import chip_smoke as c; c.phase_build(); c.{phase}()"],
            cwd=d, capture_output=True, text=True, timeout=900)
    caught = r.returncode != 0
    errors = [ln for ln in r.stderr.splitlines() if "Error" in ln]
    said = errors[-1] if errors else r.stderr.strip()[-300:]
    print(f"fault {name}: {'caught' if caught else 'MISSED'}: {said[:400]}",
          flush=True)
    return caught


def main(argv: list[str]) -> int:
    names = argv or list(FAULTS)
    unknown = [n for n in names if n not in FAULTS]
    if unknown:
        raise SystemExit(f"unknown faults {unknown}; known: {list(FAULTS)}")
    missed = [n for n in names if not run(n)]
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
