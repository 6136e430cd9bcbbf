#!/usr/bin/env python3
"""Smoke run of the PyTorch port (x3d2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check exits non-zero:

1. Device: needs CUDA; prints the card's name and power limit
   (nvidia-smi) and asserts full-float32 matmuls (TF32 off).
2. Build: compiles every kernel source (csrc/transeq_sweep.cu,
   csrc/transeq_sweep_tc.cu and csrc/transeq_sweep_w32.cu, the sweep and
   species kernels of
   csrc/transeq_sweep.cuh at W = 16 and at the HIGHEST mode's W = 32, both
   with the bfloat16 instances, csrc/pressure_pipe.cu, csrc/pipe_c_d2.cu,
   csrc/transeq_dense.cu, csrc/pressure_mid_tiled.cu and
   csrc/x_apply_manual.cu) with nvcc for sm_90a, one nvcc per source, all
   started together; prints each instance's registers and spills (the
   sweeps' halo forms named so; the tensor-core momentum sweep
   transeq_sweep_tc_kernel<AXIS, NOLDS, BASE_SEP>; the template's instances
   mat_apply_kernel<MODE, TRANS, EPI, TWO, TAIL>, TAIL 0 the 128-tiled
   ones, 1 the general ones; the split-TF32 x-apply kernel
   x_apply_tc_kernel<FORM, EPI, LINES> (EPI 0 store, 1 subtract, 2 the
   solve of pipe3's stage B; LINES: the z layout of pipe3's stages A and
   C) and its dynamic shared memory at S = 2, 4, 6, and any ptxas C7518,
   serialised wgmma, by instance). Then starts
   phase 8's CPU legs in CPU_LEG_WORKERS processes (one torch and one
   BLAS thread each), which run on the host while phases 3-7 use the
   card.
3. Kernel vs plain, float32, on the card, at every size a driven path
   gives the kernel (another size is another grid and tile count).
   Every W = 16 momentum sweep of a periodic axis but the xdiv sweep and
   the halo form runs the tensor-core body of csrc/transeq_sweep.cuh
   (split-TF32 wgmma over each 16-row slice's band; ts.tc_route): its
   row's bound is the split-TF32 one (max(bytes / 3.35 TB/s, 3 x the band
   taps' operations / 495 TFLOP/s)), the FP32 one printed beside it, a
   time below the bound a failure; it is held as every sweep is (1e-5 of
   plain f32, 3e-5 * scale of plain f64), not to plain f32's bits. Every
   counted path (phases 4-8) checks that each launch of a sweep held here
   on the tensor-core body ran that body (ts.tc_launch_counts). The W = 16
   sweeps of a non-periodic axis (512 points, Dirichlet x, Neumann y: the
   operators are not circulant) take the SIMT body: held too, at
   512 x 128 x 256 and 128 x 512 x 256, out of the kernels line (no path
   here runs them), with no tensor-core launch.
   Every W = 32 instance (X3D2_MATMUL_PRECISION=highest) at every size a
   driven HIGHEST path gives it is held to 5e-7 * scale of plain f64, the
   bound of x3d2_tpu's HIGHEST kernels (tests/test_pallas_v3.py:114); the
   xdiv sweep's du, dv, dw, the projection's transforms of u', to its
   3e-5.
   At 512^3 (main path, paths B, S, R, R4, H, HP, HA, K, M; W = 32: HI, HK,
   RI, R4I):
   - the sweeps z; x accumulate; y accumulate + AB3 with the steady and a
     startup coefficient row; y accumulate with the RK substage updates
     (history fields, base) = (0, own), (0, f0), (2, f0) (RK3's rows) and
     (3, f0) (RK4's last);
   - the reduced-precision sweeps of paths H, HP and HA: z and x
     accumulate with bfloat16 partials; y accumulate + AB3 with a bfloat16
     history alone, with bfloat16 partials alone and with both, on both
     rows. Their bfloat16
     outputs are held to one bfloat16 ulp of RNE(plain float32) plus the
     float32 limit; u' with a bfloat16 history is held as u' + dtc4
     RNE(rhs), which the neighbouring rounding of rhs on card and CPU
     leaves unchanged (sweep_fold);
   - the one-field parity x applies: forward sx, ix (x_pfwd) and inverse
     gx_s, gx_i without (x_pinv, path K) and with the correction
     (x_pinv[sub], path M), each beside one torch.matmul or torch.addmm
     of the dense operator the parity split stands for; the
     split-TF32 x-apply kernel (csrc/x_apply_manual.cu, FWD and INV
     forms), held to TC_LIM of plain f64, launched twice and at S = 2, 3,
     6 bit-equal to S = 4, each row with its device ms back to back and
     host µs a call (tools/prof_xparity.py's timings) and its split-TF32
     and FP32 bounds (parity_rows);
   - the species sweeps z; x accumulate; y accumulate, two scalars;
   - at W = 32: z; x accumulate; y accumulate + AB3 (both rows); y
     accumulate; the four RK updates; path HIA's reduced-precision sweeps
     (z and x accumulate with bfloat16 partials, y accumulate + AB3 with
     both bfloat16 streams, both rows);
   - each stage of the pressure pipeline (pipe_a, pipe_b, pipe_c), on the
     inputs the previous stage's plain version gives: two launches each
     of the split-TF32 kernel (MANUAL_SOURCE: pipe_a and pipe_c a z
     launch, then a y launch with the banded y folded into the y
     transforms; pipe_b an x FWD launch with the solve in its epilogue,
     then an x INV launch of two jobs), launched twice and bit-equal,
     their bound the split-TF32 one (the FP32 one beside it), and at
     every size a path gives them each of the six launches is timed as a
     single call, back to back and as the host's µs a call, beside its
     own bound and one batched torch.matmul (torch.baddbmm with the
     subtraction) of the dense operators it stands for (tc_launches;
     pipe_b's INV launch also held to TC_LIM of plain float64 on its own
     input); the pipeline is also held at Z_HALF (128 x 128 x 144: z
     halves of 72, on no path);
   - the slab projection: x_div3, the mid with q, the mid without q (its
     outputs bit-equal to the mid with q), the mid's halves div_solve and
     grad (X3D2_MID_SPLIT=1, path BS; bit-equal to the mid) and
     x_gradsub3;
   - stage C with the carry, pipe_c[d2] (X3D2_D2C=1, path D), on the
     inputs the plain pipe_a, pipe_b give: u', v', w' as pipe_c, the carry
     to 1e-5 of plain float32 and to 5e-7 of the plain float64 carry of
     the kernel's own u', v', w' (its function; the carry of plain float64
     end to end printed beside it), timed beside pipe_c and the z sweep it
     takes out of the step.
   At 256^3 (path A, and the same grid with X3D2_XDIV_FUSED=0): the
   sweeps z; y accumulate; the xdiv sweep (x accumulate + AB3 + the
   x-transformed divergence inputs) with the steady and a startup row, run
   twice and compared bit for bit; x accumulate; y accumulate + AB3; the
   pipeline's stages; the slab projection's functions; at W = 32 (path
   AI) z, y accumulate and the xdiv sweep.
   At (128, 128, 256), the example grid (path S-ex, and phase 8's chains
   of the AB step's modes): the sweeps z; y accumulate; the xdiv sweep;
   the reduced-precision sweeps of the xdiv chain (z and y accumulate with
   bfloat16 partials, the xdiv sweep with a bfloat16 history alone, with
   bfloat16 partials alone and with both) and y accumulate + AB3 with a
   bfloat16 history; at W = 32 (phase 8's HIGHEST chains) z, x and y
   accumulate, y accumulate + AB3 (the carry's chain), the xdiv sweep and
   the species sweeps, and the HIGHEST xdiv chains' reduced-precision
   sweeps (z and y accumulate with bfloat16 partials, the xdiv sweep with
   a bfloat16 history and with bfloat16 partials, both rows);
   the species sweeps; the mid without q and x_gradsub3, the mid also on
   white noise; the one-field parity x applies; the mid's halves, the mid
   with q and pipe_c[d2] (phase 8's X3D2_MID_SPLIT=1 and X3D2_D2C=1
   chains).
   At 128^3 (path T128): the dense transport sweeps z, x, y, held to 5e-7
   * scale of plain f64 (the bound of x3d2_tpu's HIGHEST mode), and the
   pipeline's stages.
   At 513 x 256 x 128 (path C, the cylinder): the dense x applies sx, ix,
   gx_s, gx_i and, with the correction, gx_s, gx_i, each beside one
   torch.matmul or torch.addmm on the same operands; the same applies at
   17 -> 16 and 16 -> 17 points (a remainder in K and in rows) and at 201
   -> 199 points on 36 x 20 columns (n_in, n_out and ny nz all off the
   kernel's tiles; held, not listed). Every dense x apply (here, at (65,
   128, 128), with X3D2_BFLY=0 and on the sharded blocks) is the
   split-TF32 x-apply kernel (csrc/x_apply_manual.cu): launched twice,
   bit-equal, its share of the split-TF32 bound (max(bytes / 3.35 TB/s, 3
   x operations / 495 TFLOP/s)) printed beside the FP32 bound and the
   library call, a time below the bound a failure; the
   mid over the 512 x planes with the Nyquist mask, on plane waves and on
   white noise; the solve epilogue with the mask on tables made regular
   on the zeroed line (the line exactly 0, the rest as the plain version).
   At (65, 128, 128) (phase 8's cylinders): the dense x applies, the mid
   with q and its halves.
   X3D2_BFLY=0 (the slab's dense forms; path BD at 512^3 and phase 8's
   dense chains at 128 x 128 x 256): the dense x applies of a periodic x
   (each beside one torch.matmul / torch.addmm), the dense mid with q
   (and at 128 x 128 x 256 without q, and its halves div_solve[dense] and
   grad[dense]) on plane waves, and on white noise (mid_on_noise). The
   dense y and z applies are launches of the mid, not wrappers of their
   own: they are held inside it.
   The sharded step's kernels (phase 9) at the blocks its ranks hold: 512 x
   256 x 256 (512^3 on (2, 2)) and 128^3 (128 x 256 x 256 on (2, 2), also
   in the HIGHEST mode and with the species sweeps, and 128 x 128 x 512 on
   (1, 4)): the sweeps z, x + acc, y + acc, in the halo form on a sharded
   axis (their extended operands sliced from a global field, at the last
   rank: a nonzero block offset), the one-field x_pfwd and x_pinv[sub], and
   the mid over the rank's x batch with its table slices
   (pressure_mid[q,local] at 128 x 512 x 512, 32 x 256 x 256 and 32 x 128
   x 512, on plane waves); at 128 x 256 x 256 on (2, 2) also X3D2_BFLY=0's
   dense x applies of the block (x_apply, x_apply[sub] at 128^3) and
   dense mid over the x batch (pressure_mid[q,dense,local] at 32 x 256 x
   256). At 1024^2 planes (128 x 1024 x 1024 on (2, 2): the blocks 128 x
   512 x 512) the sweeps, x_pfwd and x_pinv[sub] of the block, and in
   place of the local mid x3d2_tpu's y/z-tiled mid over the x batch (32 x
   1024 x 1024; and at the batch 16 x 128 x 256 of 64 x 128 x 256 on (2,
   2), held, not listed): its three kernels pressure_mid[tiled,t1], [t2],
   [t3] each on the inputs the previous one's plain version gives, the
   first on plane waves, then the three in turn against the plain tiled
   mid (float32 and float64) and on white noise (mid_on_noise's limits).
   max |kernel - plain f32| <= 1e-5 * scale and max |kernel - plain f64|
   <= 3e-5 * scale (scale = max |plain f64|); kernel and plain times (CUDA
   events, median) beside the bound. The mid's inputs there are plane
   waves; on white noise, at both sizes, it is held to what the plain
   float32 version reaches against float64 in the same run, and q times
   its wave factor (every mode, so every solve-table entry) to the limits
   above (mid_on_noise). The whole projection on the slab kernels is held
   to 1e-5 * scale of the transform-folded chain and of the pipeline.
   The tails (the template's general instance, at extents x3d2_tpu's gates
   admit past its 128-point tiles): at PX = 320 x 256 x 384 the sweeps z,
   x + acc, y + acc + AB3 (both rows), the pipeline's stages, and held but
   on no path pipe_c[d2] (the carry at nz = 384), x_pfwd and x_pinv[sub]
   at x = 320 (beside torch.matmul / addmm); at PY = 384 x 192 x 384 the
   pipeline's stages, the slab (x_div3, the mid with and without q, its
   halves, x_gradsub3) and the local mid over a rank's batch of 32 planes
   (held); at YD = 256 x 200 x 256 the slab on the folded y (the mid in 4
   launches: the dense y at 200, the z transforms with the solve, their
   inverse, the dense y). The x-apply kernel's manual entry
   (csrc/x_apply_manual.cu) in its five forms (dense, dense with the
   subtraction, parity forward, inverse, inverse with the subtraction) on
   tools/prof_manual.py's operators at 512^3 and (held) at x = 320, each
   at S = 4 beside one torch.matmul / torch.addmm, and at 512^3 at S = 2,
   3, 6 bit-equal to S = 4 and timed.
   PR 11: the carry's streamed form (csrc/pipe_c_d2.cu past nz = 512)
   and the tiled mid's long form (csrc/pressure_mid_tiled.cu past 1024
   points along y or z). At (128, 128, 640) (phase 8's carried chain) the
   boot z sweep, x + acc, y + acc + AB3 (both rows), pipe_a, pipe_b and
   pipe_c[d2]; at 512 x 512 x 1024 (paths DZ and MZ) the same and pipe_c,
   the sweeps and the carry compared on 64 x planes or y rows (their plain
   float64 versions on the whole grid would not fit beside the kernels'),
   timed whole; past nz = 512 the carry end to end against plain float64
   within twice plain float32's own distance to it, not below 5e-7, and
   u', v', w' and the carry against plain float32 within twice plain
   float32's own distance to float64, not below 1e-5; at 512^3 the
   streamed form bit-equal to the resident one; pipe_c[d2] held on no
   path at 128 x 128 x 1536 (the largest nz x3d2_tpu's gates admit on
   128^2 planes). In
   phase 3h the ranks' blocks of SH-ty (128 x 2048 x 256 on (2, 2): 128 x
   1024 x 128) and SH-tz (128 x 256 x 2048: 128 x 128 x 1024) and the
   tiled mid on their x batches, 32 x 2048 x 256 and 32 x 256 x 2048; the
   tiled mid held on no path on a rank's batch of 128 x 2048 x 2048 and of
   128 x 3968 x 128 (the largest y x3d2_tpu's tiled gate admits). On
   planes of 2048 points and more the tiled kernels are held against plain
   float64 within twice plain float32's own distance to it on the same
   inputs (the white-noise rule), not below 3e-5, and the three in turn
   against plain float32 within the same, not below 1e-5.
4. Main path: TGV 512^3 AB3 float32, keep_pressure=False, through
   TGVCase.run(n_iters=10), with every launch count set to 0 just before:
   3 sweep launches and the pipeline's 8 launches per step, finite and
   decreasing KE, div_u_max below its limit; then ms/step and the share of
   the step in the sweeps and in the projection.
4b. The AB step's modes at 512^3, each through TGVCase.run with the
   counts set to 0 just before, the main path's KE and divergence checks,
   and ms/step beside the main path's:
   - path H: X3D2_BF16_OLDS=1, 10 steps: the sweeps z, x + acc and y + acc
     + AB3 with the bfloat16 history, and the pipeline; the history
     bfloat16;
   - path HP: X3D2_BF16_ACC=1 alone: every sweep on bfloat16 partials, the
     history float32 (u' over its oldest buffer, rhs into new tensors);
   - path HA: both switches: every sweep on bfloat16 partials, the history
     bfloat16;
   - path K: SolverParams(compensated=True), 10 steps, 13 launches a step:
     the solver.transeq chain (z, x + acc, y + acc), x_div3, the mid with q
     (6) and the one-field parity inverse without the correction (3), no
     pipeline launch; a finite compensation;
   - path M: X3D2_MERGED_X=0 with keep_pressure=True, 3 steps: the z, x, y
     chain, 3 x_pfwd, the mid with q (6) and 3 x_pinv[sub]; its ms/step
     printed beside K and HK.
4c. The HIGHEST mode (X3D2_MATMUL_PRECISION=highest) at 512^3, the main
   path's checks, ms/step, only W = 32 sweep instances launched:
   - path HI: the main path, 10 steps;
   - path HK: with compensated stepping (the production-accuracy mode),
     10 steps, the launches of path K at W = 32;
   - path HIA: with both bfloat16 streams (X3D2_BF16_OLDS=1,
     X3D2_BF16_ACC=1), 10 steps: path HA's chain on the W = 32 instances
     and the pipeline; the history bfloat16.
4d. Path D: the main path with X3D2_D2C=1, 10 steps: per step the x
   and y sweeps from the carried partials, pipe_a, pipe_b and pipe_c[d2]
   (3 launches), and one boot z sweep per run (the partials made anew
   from the state entering run); one step counted alone shows no z sweep;
   the main path's checks; ms/step.
4e. Paths DZ and MZ: TGV 512 x 512 x 1024 AB3 float32,
   keep_pressure=False, 10 steps each, with X3D2_D2C=1 (the carry's
   streamed form) and without it (the main path's chain at that grid);
   the main path's checks; ms/step of each and their ratio.
5. Path B: the same case with keep_pressure=True, 10 steps: 3 sweeps, 1
   x_div3, the mid's 6 and 1 x_gradsub3 launch per step and no pipeline
   launch; the same KE and divergence checks; the physical pressure of the
   last step against the transform-folded chain's on the same input
   (p_tolerance: 1e-5 of max |p| plus four float32 roundings of the
   velocity); ms/step. Path BS: the same with X3D2_MID_SPLIT=1 (x_div3,
   div_solve, grad, x_gradsub3); path BD: with X3D2_BFLY=0 (the z, x, y
   chain, 3 x_apply, the dense mid with q, 3 x_apply[sub]); both with the
   pressure check; ms/step.
6. Path A: TGV 256^3, keep_pressure=False, 20 steps: the xdiv chain's 3
   sweeps, the mid's 6 and 1 x_gradsub3 launch per step, no pipeline and
   no x_div3 launch; KE and divergence checks; a second run from the same
   initial state gives bit-identical u, v, w; ms/step; then the same grid
   with X3D2_XDIV_FUSED=0 (the z, x, y chain and the pipeline), timed the
   same way, and path AI: the xdiv chain in the HIGHEST mode (W = 32). The
   times are printed; none is asserted to be the faster.
7. Passive scalars, Runge-Kutta and TGV 128^3, keep_pressure=False, with
   the same checks, and for the scalars phi finite and its variance (sum
   of phi^2, in float64) lower at the end than at the start:
   - path S: TGV 512^3 AB3 with two scalars (Pr 0.7 and 1.0), 10 steps: the
     main path's launches and the species sweeps z, x, y once a step;
     ms/step and the share of the species sweeps;
   - path S-ex: examples/TGV_species/input.x3d read by the port's
     config.py, at its grid (128, 128, 256), 20 steps: the xdiv chain, the
     species sweeps, the mid (6) and x_gradsub3 once a step;
   - path R: TGV 512^3 RK3, 10 steps: per substage the RK sweep chain (z,
     x + acc, y + acc + the substage update) and the pipeline, 33 launches
     a step; path R4: RK4, 3 steps, whose last substage reads three stage
     derivatives; paths RI and R4I: RK3 and RK4 in the HIGHEST mode, 3
     steps, W = 32 sweeps only;
   - path T128: TGV 128^3 AB3, 20 steps: the unfused AB step x3d2_tpu
     takes there, the dense transport sweeps z, x, y and the pipeline's 8
     launches a step, no sweep launch; ms/step and the shares.
7d. The tails' paths, TGV AB3, 10 counted steps, ms/step and the
   projection's share: PX (320 x 256 x 384: the z, x, y sweeps and the
   pipeline), PY (384 x 192 x 384: x3d2_tpu's einsum transport, plain
   matrix products, and the pipeline), PYB (PY with keep_pressure=True:
   x_div3, the mid with q, x_gradsub3; the physical pressure held as path
   B's), YD (256 x 200 x 256: the einsum transport and the slab on the
   folded y without q); the launches counted, the main path's KE and
   divergence checks.
7c. tools/prof_manual.py once at 512^3 (the manual entry point of the
   x-apply kernel: the kernel at S = 2, 3, 4, 6, in the parity forms the
   operator-apply template's PFWD / PINV along x (the one-field x applies'
   kernel before the x-apply kernel took them), and one torch call of
   each form, held to
   1e-5 / 3e-5 of plain f32 / f64), its JSON line and one line a form
   (times, shares of the split-TF32 bound) printed; its launches are the
   manual entry's in the kernels line.
7b. The cylinder (x inflow and convective outflow, IBM), AB3,
   keep_pressure=False, built by the port's config.py from
   examples/cylinder/input.x3d:
   - path C: at 513 x 256 x 128 (dims_global overridden), 10 steps: per
     step 3 x_apply, 3 x_apply[sub] and the mid's 6 launches, nothing
     else (the transport is x3d2_tpu's einsums: plain matrix products);
     u, v, w finite, the inflow plane's mean within 0.1 of 1, |u| < 0.5
     at the body's centre, div_u_max below CYL_DIV_LIMIT; ms/step and the
     projection's share, beside PR 11's ms/step (as path BD's and SH-d's,
     the runs that take the dense x apply);
   - path C-ex: the example at its own 257 x 128 x 32, 10 steps: no kernel
     launch at all (x3d2_tpu runs none there), finite.
8. Slice as a whole: float32, 10 steps on the card (kernels) and on the
   CPU (plain versions); TGV (128, 128, 256): AB3 through the xdiv path,
   with keep_pressure=True, and with X3D2_XDIV_FUSED=0; AB3 with two
   scalars; RK3 fused; RK3 with two scalars (the unfused RK branch); TGV
   128^3 AB3 (the dense sweeps, unfused); the cylinder at (65, 128, 128)
   AB3 with inlet_noise = 0 (unfused, dense transport, the slab with the
   dense x stage). The AB step's modes, the card's run counted as the
   paths': at (128, 128, 256) the xdiv path with a bfloat16 history, with
   bfloat16 partials alone, with both, and with a bfloat16 history and
   X3D2_XDIV_FUSED=0; compensated with two scalars and a bfloat16 history
   (the compensated step's kernels; path K and the HIGHEST compensated
   chain hold it without them); X3D2_MERGED_X=0
   with keep_pressure=True and X3D2_XDIV_FUSED=0; the cylinder at (65,
   128, 128) compensated (the dense x applies without the correction). In
   the HIGHEST mode, counted (W = 32 sweeps only): the xdiv path,
   compensated, RK3 with two scalars, the xdiv path with a bfloat16
   history and with bfloat16 partials. The projection switches, counted:
   X3D2_D2C=1 with X3D2_XDIV_FUSED=0, also in the HIGHEST mode and with a
   bfloat16 history; X3D2_MID_SPLIT=1 on the xdiv path and with
   keep_pressure=True; X3D2_BFLY=0 with keep_pressure=True, with
   keep_pressure=False (the z, x, y chain and the pipeline), compensated,
   with X3D2_MID_SPLIT=1 (keep_pressure=True) and with X3D2_PIPE3=0 (the
   dense mid without q); the cylinder at (65, 128, 128) with
   X3D2_MID_SPLIT=1. The tails: TGV (192, 128, 256) (the sweeps and the
   pipeline at an x tail) and (128, 136, 128) (the slab on the folded y).
   PR 11: X3D2_D2C=1 at (128, 128, 640) (the carry's streamed form;
   counted; 3 steps, CHAIN_STEPS_LONG), and the scalars off the species
   sweeps, x3d2_tpu's per-species einsums as plain PyTorch on the card:
   TGV 128^3 with 2 scalars (the v1 route), the cylinder at (65, 128, 128)
   with 1 scalar (the dense route; the cylinder defines no scalars, so
   each starts as u - 1) and (128, 128, 256) with 9 scalars (past the
   species sweeps' 8; 3 steps, CHAIN_STEPS_LONG: its CPU leg set the
   run's length at 10).
   The CPU legs come from the worker processes started after phase 2.
   A chain whose CPU leg is bit-identical to an earlier one's (with
   X3D2_MID_SPLIT=1: the xdiv path, keep_pressure=True, X3D2_BFLY=0 with
   keep_pressure=True and the cylinder; X3D2_BFLY=0 with
   keep_pressure=False as X3D2_XDIV_FUSED=0; X3D2_BFLY=0 with
   X3D2_PIPE3=0 as X3D2_BFLY=0 with keep_pressure=True, its velocities)
   takes that CPU leg.
   Each leg prints the card's ms/step (10 steps, monitoring on).
   max |du, dv, dw| <= 1e-5 and max |dphi| <= 1e-5, KE relative
   difference <= 1e-6, p within p_tolerance; with bfloat16 stores each of
   the first two widened by what one bfloat16 ulp of the largest rhs (or
   partial) R entering u' through dt (sum |c_j| + |c4|) per rounded
   stream and step can give: 10 n dt 4.58 2^-7 R (n = 1 with the history,
   2 with the partials alone, 3 with both), and the KE limit by that times mean(|u| +
   |v| + |w|) / KE.
8q. The paths' step times on a quiet host: phases 4-7 time their steps
   while phase 8's CPU legs keep 7 of the host's cores busy, so once the
   legs are done the main path and the tails' paths PX, PY, PYB, YD are
   built and timed again (3 warm-up steps, then 10) and each median is
   printed beside the one taken with the legs running, with the ratio.
   Every ms/step of phases 4-7 also prints the fastest and slowest of its
   10 steps.
8b. KE in the HIGHEST mode: TGV (128, 128, 256) to t = KE_T, float32
   HIGHEST + compensated against the float64 einsum leg (X3D2_PALLAS=0),
   both on the card (x3d2_tpu_torch.tools.ke_parity): max |dKE| / KE0 <=
   KE_LIMIT.
9. The sharded step (x3d2_tpu make_sharded_step's counterpart,
   x3d2_tpu_torch.parallel): 4 ranks spawned on this host
   (x3d2_tpu_torch.tools.shard_run), on one card with gloo (the exchanges
   staged through host memory), one card per rank with nccl where the
   cards cover the ranks; the transport and placement printed. Per rank
   the launches (set to 0 just before the timed steps), ms/step (host
   clock, the device synchronised) and the share of the halo exchanges and
   the all-to-alls; a failing rank fails the run. Runs: the main sharded
   path, TGV 512^3 AB3 float32 keep_pressure=False on (2, 2), 2 warm-up
   and 3 timed steps (per rank and step: transeq_sweep[z,halo], [x,acc],
   [y,acc,halo], 3 x_pfwd, pressure_mid[q,local] (6 launches), 3
   x_pinv[sub]; no pipeline, no x_div3); TGV 128 x 1024 x 1024 on (2, 2),
   1 warm-up and 2 timed steps, the same launches with the y/z-tiled mid
   (pressure_mid[tiled,t1], [t2], [t3]) in place of the local one, as
   x3d2_tpu takes it at 1024^2 planes; TGV 128 x 256 x 256 on (2, 2) with
   2 scalars, 5 steps, and the same in the HIGHEST mode (the W = 32 halo
   instances); TGV 128 x 128 x 512 on (1, 4), 5 steps; TGV 128 x 256 x
   256 on (2, 2) RK3 with X3D2_FUSED_RK=0 (the sharded unfused RK step, 3
   substages a step) and keep_pressure=True, 3 steps, and AB3 with
   X3D2_BFLY=0 (3 x_apply, pressure_mid[q,dense,local], 3 x_apply[sub])
   and keep_pressure=True, 5 steps; SH-ty (128 x 2048 x 256) and SH-tz
   (128 x 256 x 2048) on (2, 2), 3 steps each, the tiled mid's long form
   (2048 points along y, along z) in place of the local mid. Each
   gathered u, v, w
   (phi) against the port's single-card step of the same arithmetic
   (X3D2_FUSED_AB=0, X3D2_MERGED_X=0, keep_pressure=True, the run's
   switches) after the same steps, run by rank 0 with the ranks' BLAS
   threads, which compares and returns the numbers: within 1e-6 * max
   |u|, bit-equality reported (the tiled run's single card takes the
   merged mid: not bit-equal); a kept p within p_tolerance of the
   single-card p. Rank 0's seconds of each run's stages are printed.
10. Every held kernel was launched on a path at its size, and every kernel
   a counted path launched was held at that size; the total wall time
   (and, before, when each phase started), the kernels line (JSON; one
   entry per kernel and size a path gives it, named kernel@n, n the edge
   of a cubic grid or nx x ny x nz, its launches those of the path run at
   that size), the card line, and the result line.

It imports nothing of JAX or of the JAX package.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from functools import partial

NS = 512                    # grid of the main path, paths B, S, R, R4
NA = 256                    # grid of path A (the xdiv chain)
NT = 128                    # grid of path T128 (the dense sweeps)
SMALL = (128, 128, 256)     # whole-slice comparison grid, the example's
# phase 9's checked sharded runs: (2, 2) (with scalars, and in the HIGHEST
# mode) and z only (1, 4); both give every rank a 128^3 block
SHARD_SMALL = (128, 256, 256)
SHARD_Z = (128, 128, 512)
# phase 9's run at 1024^2 planes, where x3d2_tpu's repencilled projection
# takes its y/z-tiled mid (its full-plane mid exceeds the TPU's VMEM): each
# rank holds 128 x 512 x 512, the mid's x batch is 32 x 1024 x 1024
SHARD_TILED = (128, 1024, 1024)
# the tiled mid held at a small size too: the batch of this grid on (2, 2)
TILED_SMALL = (64, 128, 256)
# phase 9's runs through the tiled mid's long form (past 1024 points along
# y, SH-ty, or z, SH-tz): each rank holds 128 x 1024 x 128 or 128 x 128 x
# 1024, the mid's x batch is 32 planes of 2048 x 256 or 256 x 2048
SHARD_TY = (128, 2048, 256)
SHARD_TZ = (128, 256, 2048)
SHARD_LONG = (SHARD_TY, SHARD_TZ)
# the tiled mid's long form held on a rank's batch of grids no path runs:
# the square 2048^2 planes (128 x 2048^2 on four gloo ranks and a
# single-card reference would not fit one card) and the largest y x3d2_tpu's
# tiled gate admits at terms 2 (3968, at z = 128)
TILED_HELD = ((128, 2048, 2048), (128, 3968, 128))
# the carry's streamed form: paths DZ (X3D2_D2C=1) and MZ (the main path's
# chain without it) at 512 x 512 x 1024; phase 8's carried chain at 128 x
# 128 x 640; held on no path at 128 x 128 x 1536, the largest nz x3d2_tpu's
# gates admit on 128^2 planes (its slab's VMEM estimate; the port takes no
# such limit over, and its kernel takes nz at run time: 2048 and 4096 are
# left out, their solvers' builds on a host whose cores phase 8's CPU legs
# hold cost more than the run has room for)
DZ = (512, 512, 1024)
D640 = (128, 128, 640)
CARRY_HELD = ((128, 128, 1536),)
# the tails' paths: extents x3d2_tpu's gates admit past the template's
# 128-point tiles. PX: x3d2_tpu's sweeps and pipe3 with an x tail (parity
# halves of 160); PY (and PYB, with the pressure kept): its dense-einsum
# transport and pipe3 (the slab) with a y tail (3 banded blocks of 64,
# halves of 96); YD: the slab on the folded y (a periodic y not tiled by
# 64), where pipe3 is not admitted
PX = (320, 256, 384)
PY = (384, 192, 384)
YD = (256, 200, 256)
# the pipeline held at a z half not a multiple of 16 (halves of 72): the
# split-TF32 kernel's stages A and C with their last k chunk part-filled
Z_HALF = (128, 128, 144)
EXAMPLE = "examples/TGV_species/input.x3d"   # path S-ex
CYL_EXAMPLE = "examples/cylinder/input.x3d"  # paths C and C-ex
# path C: the example refined 2x in x and y and 4x in z (the smallest span
# the slab tiles)
CYL = (513, 256, 128)
CYL_SMALL = (65, 128, 128)  # the cylinder's card vs CPU grid
STEPS = 10                  # steps at 512^3 (path R4: STEPS_R4)
STEPS_A = 20                # steps at 256^3 and on the example grid
SHARD_STEPS = 5             # timed steps of phase 9's runs at 128^3 blocks
STEPS_R4 = 3
PR = (0.7, 1.0)             # the example's scalars
# phase 8b: the KE check's horizon and limit. In the long runs of
# x3d2_tpu_torch.tools.ke_parity on an H100 (PERF.md, KE parity) the float32
# HIGHEST + compensated curve at (128, 128, 256) leaves the float64 one
# linearly, by ~1.9e-7 of KE0 per unit of time (the same with W = 16 and
# without the compensation: the float32 evaluation of the operators, not
# the band or the state's accumulation), and reads 7.49e-8 at t = 0.4; the
# limit is twice that.
KE_T = 0.4
KE_LIMIT = 1.5e-7
DT = 1e-3
# f32 projection level of div_u_max: the f32 plain path on the CPU reaches
# 7.5e-6, 2.4e-5 and 7.3e-5 at 64^3, 128^3 and 256^3 after two TGV steps
# (about 3x per doubling, the derivative operators' 1/dx growth), so about
# 2e-4 is expected at 512^3. The limits are 5x the expected level.
# At 384 (paths PX, PY), the 3x-per-doubling growth from 256 gives about
# 1.35e-4; the limit is 5x that.
# At 1024 (paths DZ, MZ: 512 x 512 x 1024) the same growth gives 6e-4
# and the limit is 5x that.
DIV_LIMIT = {1024: 3e-3, 512: 1e-3, 384: 6.8e-4, 256: 3.65e-4,
             128: 1.2e-4}   # by max(dims)
# path C: after one step of the cylinder (the first projection of the white
# initial noise; the level falls after it) the float32 plain path on the
# CPU reaches 2.56e-5, 2.88e-5 and 3.07e-5 at (65, 128, 128), (129, 128,
# 128) and (257, 128, 128), and 1.79e-4 at (129, 256, 128): x refinement
# moves it 1.2x from 65 to 257 points, halving dy 6x (the noise is white in
# y). About 2.2e-4 is expected at (513, 256, 128); the limit is 5x that
# (python3 -m x3d2_tpu_torch.tools.div_level examples/cylinder/input.x3d
# 65 128 128 129 128 128 257 128 128 129 256 128).
CYL_DIV_LIMIT = 1.1e-3
# H100 SXM data-sheet rates (NVIDIA), dense, at the 700 W limit
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
SWEEP_SOURCE = "x3d2_tpu_torch/csrc/transeq_sweep.cu"
# the tensor-core momentum sweeps (csrc/transeq_sweep.cuh's
# transeq_sweep_tc_kernel): every W = 16 sweep of a periodic axis but the
# xdiv sweep and the halo form
SWEEP_TC_SOURCE = "x3d2_tpu_torch/csrc/transeq_sweep_tc.cu"
# the W = 32 instances (X3D2_MATMUL_PRECISION=highest); both sources hold
# the kernels of csrc/transeq_sweep.cuh at one block geometry each
SWEEP32_SOURCE = "x3d2_tpu_torch/csrc/transeq_sweep_w32.cu"
PIPE_SOURCE = "x3d2_tpu_torch/csrc/pressure_pipe.cu"
# the last launch of pipe_c[d2] (its first two: PIPE_SOURCE's template)
CARRY_SOURCE = "x3d2_tpu_torch/csrc/pipe_c_d2.cu"
DENSE_SOURCE = "x3d2_tpu_torch/csrc/transeq_dense.cu"
# the y/z-tiled mid of the repencilled projection at 1024^2 planes
TILED_SOURCE = "x3d2_tpu_torch/csrc/pressure_mid_tiled.cu"
# the split-TF32 x-apply kernel: the dense x apply (x_apply, x_apply[sub]),
# the one-field parity x applies (x_pfwd, x_pinv, x_pinv[sub]) and
# the manual entry, on no solver path (tools/prof_manual.py)
MANUAL_SOURCE = "x3d2_tpu_torch/csrc/x_apply_manual.cu"
# the pipeline's stages: two launches each of MANUAL_SOURCE's kernel (A and
# C a z launch, the transposed form, and a y launch batched over x planes;
# B an x FWD launch with the solve, then an x INV launch); none of them on
# PIPE_SOURCE's template
PIPE_TC = ("pipe_a", "pipe_b", "pipe_c")
# the split-TF32 kernel's limit against plain float64, relative to max
# |plain f64|: under the HIGHEST mode's 5e-7 (tests/test_pallas_v3.py:114)
TC_LIM = 4e-7
# PR 11's ms/step (its final run, H100 80GB HBM3, 700 W) of the runs that
# take the dense x apply, printed beside this run's; the compensated
# cylinder's card leg (10 steps, counted) read 0.2 s in its log
PR11_MS = {"path C": 18.612, "path BD": 107.261, "SH-d": 181.713}
REPLACES = {2: "x3d2_tpu/ops/pallas_kernels.py:671",
            0: "x3d2_tpu/ops/pallas_kernels.py:172",
            1: "x3d2_tpu/ops/pallas_kernels.py:172",
            "species": "x3d2_tpu/ops/pallas_kernels.py:1038",
            "pipe_a": "x3d2_tpu/ops/pallas_poisson.py:1378",
            "pipe_b": "x3d2_tpu/ops/pallas_poisson.py:1405",
            "pipe_c": "x3d2_tpu/ops/pallas_poisson.py:1455",
            "x_div3": "x3d2_tpu/ops/pallas_poisson.py:1067",
            "pipe_c[d2]": "x3d2_tpu/ops/pallas_poisson.py:1455",
            "pressure_mid[q]": "x3d2_tpu/ops/pallas_poisson.py:354",
            "pressure_mid": "x3d2_tpu/ops/pallas_poisson.py:354",
            "pressure_mid[q,dense]": "x3d2_tpu/ops/pallas_poisson.py:354",
            "pressure_mid[dense]": "x3d2_tpu/ops/pallas_poisson.py:354",
            "div_solve": "x3d2_tpu/ops/pallas_poisson.py:327",
            "grad": "x3d2_tpu/ops/pallas_poisson.py:340",
            "div_solve[dense]": "x3d2_tpu/ops/pallas_poisson.py:327",
            "grad[dense]": "x3d2_tpu/ops/pallas_poisson.py:340",
            "x_gradsub3": "x3d2_tpu/ops/pallas_poisson.py:1106",
            "transeq_dense": "x3d2_tpu/ops/pallas_transeq.py:42",
            "x_apply": "x3d2_tpu/ops/pallas_poisson.py:954",
            "x_apply[sub]": "x3d2_tpu/ops/pallas_poisson.py:954",
            "x_pfwd": "x3d2_tpu/ops/pallas_poisson.py:997",
            "x_pinv": "x3d2_tpu/ops/pallas_poisson.py:1025",
            "x_pinv[sub]": "x3d2_tpu/ops/pallas_poisson.py:1025",
            # the halo_ext forms (n_shards > 1) and make_mid_local
            "halo": "x3d2_tpu/ops/pallas_kernels.py:238",
            "species_halo": "x3d2_tpu/ops/pallas_kernels.py:1061",
            "pressure_mid[q,local]": "x3d2_tpu/ops/pallas_poisson.py:780",
            "pressure_mid[q,dense,local]":
                "x3d2_tpu/ops/pallas_poisson.py:780",
            "pressure_mid[tiled,t1]": "x3d2_tpu/ops/pallas_poisson.py:413",
            "pressure_mid[tiled,t2]": "x3d2_tpu/ops/pallas_poisson.py:430",
            "pressure_mid[tiled,t3]": "x3d2_tpu/ops/pallas_poisson.py:468",
            # the folded y (its branches of _div_solve_body, _grad_body)
            "pressure_mid[folded_y]": "x3d2_tpu/ops/pallas_poisson.py:354",
            "pressure_mid[q,folded_y]": "x3d2_tpu/ops/pallas_poisson.py:354",
            "div_solve[folded_y]": "x3d2_tpu/ops/pallas_poisson.py:327",
            "grad[folded_y]": "x3d2_tpu/ops/pallas_poisson.py:340",
            "x_apply_manual": "x3d2_tpu/ops/pallas_manual.py:200"}
# phase 8's chains whose CPU leg is that of another chain (label, then the
# label of the chain it takes the leg from; "cylinder" names the cylinder
# at CYL_SMALL, else TGV at SMALL): the plain versions run the same
# operations, so the legs are bit-identical. The mid's halves compose to the
# mid, and with keep_pressure=False X3D2_BFLY=0 leaves the z, x, y chain and
# the pipeline (which keeps its parity splits) as X3D2_XDIV_FUSED=0 has
# them; with X3D2_PIPE3=0 it takes the slab's dense forms as with
# keep_pressure=True, whose velocities it shares (the plain mid forms q
# either way; phase 8 holds p only where a chain keeps it). Each label
# names its chain's switches (chain_switches);
# tests/test_torch_shared_legs.py steps each pair on the CPU and asserts
# the states bit-equal.
CPU_SAME = (("X3D2_MID_SPLIT=1, xdiv path", "xdiv path"),
            ("X3D2_MID_SPLIT=1, keep_pressure=True", "keep_pressure=True"),
            ("X3D2_MID_SPLIT=1, X3D2_BFLY=0, keep_pressure=True",
             "X3D2_BFLY=0, keep_pressure=True"),
            ("X3D2_BFLY=0, keep_pressure=False", "X3D2_XDIV_FUSED=0"),
            ("X3D2_BFLY=0, X3D2_PIPE3=0", "X3D2_BFLY=0, keep_pressure=True"),
            ("cylinder, X3D2_MID_SPLIT=1", "cylinder"))
BF16_ULP = 2.0 ** -7        # a bfloat16 ulp, relative to the value's binade


def chain_switches(label):
    """(case, switches, keep_pressure) that a CPU_SAME label names: its
    comma-separated items X3D2_...=value and keep_pressure=True|False;
    case "cylinder" where the label starts with it, else "tgv"."""
    env, keep = {}, False
    for item in label.split(", "):
        key, _, val = item.partition("=")
        if key.startswith("X3D2_"):
            env[key] = val
        elif key == "keep_pressure":
            keep = val == "True"
    return ("cylinder" if label.startswith("cylinder") else "tgv"), env, keep


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps, torch):
    """Median time of fn() over `reps` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def size_label(shape):
    """The edge of a cubic grid, else nx x ny x nz."""
    return str(shape[0]) if len(set(shape)) == 1 else "x".join(map(str,
                                                                   shape))


def sweep_cost(shape, accumulate, nolds, w, xdiv=False, upd=None,
               base_sep=False, olds_bf16=False, acc_bf16=False, ext=1.0):
    """(bytes, flops) the sweep function needs: each input field read once
    and each output written once; the band taps each output needs (2w + 1
    per operator: D1, D2 and D1d, for 3 components), the q*conv products,
    the combine, the accumulate and the time update (upd, default nolds >
    0; base_sep: three more inputs, the RK step-initial fields). The
    kernel's 96-wide block rows (BS + 2W) are its design, not a need of the
    function. With xdiv: three more outputs and three parity-split x
    applies. A bfloat16 history (olds_bf16: the history read, rhs written)
    and bfloat16 partials (acc_bf16: acc read, and r written without the
    update) are 2-byte streams; the history's error feedback adds a
    rounding, a subtraction and a multiply-add per output. ext: the halo
    form's u, v, w are read from their extended operands, (n + 2W) / n of a
    field each."""
    upd = nolds > 0 if upd is None else upd
    npts = shape[0] * shape[1] * shape[2]
    hb, ab = (2 if olds_bf16 else 4), (2 if acc_bf16 else 4)
    nbytes = 4 * 3 * (ext + (1 if base_sep else 0) + (1 if xdiv else 0)) \
        + (3 * ab if accumulate else 0) + 3 * nolds * hb \
        + ((3 * 4 + 3 * hb) if upd else 3 * ab)
    per_pt = 3 * (2 * 3 * (2 * w + 1) + 1 + 5) + (3 if accumulate else 0)
    if upd:
        per_pt += 3 * (2 + 2 * nolds) + (3 * 4 if olds_bf16 else 0)
    if xdiv:
        per_pt += 3 * (shape[0] + 1)
    return npts * nbytes, npts * per_pt


def species_cost(shape, nsp, accumulate, w, ext=1.0):
    """(bytes, flops) of the species sweep function, counted as sweep_cost
    counts: the conv and each scalar read once (and each accumulator), each
    scalar's rhs written once; per scalar the band taps of D1, D2 and D1s,
    the phi*conv product and the combine. ext: as sweep_cost's, for conv
    and the scalars."""
    npts = shape[0] * shape[1] * shape[2]
    nfields = (1 + nsp) * ext + nsp * (1 + (1 if accumulate else 0))
    per_pt = nsp * (2 * 3 * (2 * w + 1) + 1 + 5 + (1 if accumulate else 0))
    return 4 * npts * nfields, npts * per_pt


def pipe_cost(stage, shape, w):
    """(bytes, flops) of one pipeline stage: fields read once and written
    once (the operators are under 1% and left out); the parity-split dense
    applies (n/2 multiply-adds per output and one add for the f1 +/- f2 or
    a +/- b combine), the banded applies (2w + 1 taps), the solve (waves,
    reciprocal, scale) and the correction. Stages A and C count the
    cheaper of two orders of the same function: the banded y apart, or
    folded into the y transforms (on every grid the pipeline takes, a y
    operator is circulant and Ty C, C Tyi are parity operators of the
    transforms' size: ops/pressure_pipe.py fold_y), which spares C's
    banded applies and costs A a third y transform."""
    nx, ny, nz = shape
    npts = nx * ny * nz
    band = 2 * (2 * w + 1) + 0.0
    if stage == "pipe_a":
        # z: Iz p1, Iz p2 + Sz p3; y: 3 banded y, then Ty z1, Ty z23; or
        # folded: Ty Iy z1, Ty Sy z2 + Ty Iy z3
        per_pt = 3 * (nz + 1) + min(3 * band + 2 * (ny + 1),
                                    3 * (ny + 1) + 1)
        fields = 3 + 2
    elif stage == "pipe_b":
        # x: Sx a + Ix e, solve; x: Gxs q, Gxi q
        per_pt = 2 * (nx + 1) + 5 + 2 * (nx + 1)
        fields = 2 + 2
    else:
        # z: Gzi X, Gzs Y, Gzi Y; y: 3 inverse transforms (the banded y
        # folded in: none apart), minus
        per_pt = 3 * (nz + 1) + 3 * (ny + 1) + 3
        fields = 5 + 3
    return 4 * npts * fields, npts * per_pt


def slab_cost(stage, shape, w, y="parity", z="parity"):
    """(bytes, flops) of one function of the slab projection, counted as
    pipe_cost counts: x_div3 three parity x applies, 3 fields in and 3
    out; x_gradsub3 three inverse parity x applies and the correction, 6
    in and 3 out; the mid 6 banded y applies (Iy du, Sy dv, Iy dw; Giy,
    Gsy, Giy), 4 z transforms (Iz, Sz; Gzi, Gzs), 3 y transforms (Ty;
    Ti_y twice) and the solve, 3 in and 3 out, one more with q; its halves
    div_solve (3 banded, 2 z, 1 y and the solve; 3 in, q out) and grad (2
    z, 2 y, 3 banded; q in, 3 out). A transform is a parity split (n/2
    multiply-adds and the combine per output) or, dense, n multiply-adds
    per output; y and z: the forms (parity.Forms). On the folded y the y
    stages are 3 dense y applies each way (Iy du, Sy dv, Iy dw; Giy, Gsy,
    Giy) in place of the banded ones and the y transforms."""
    nx, ny, nz = shape
    npts = nx * ny * nz
    band = 2 * (2 * w + 1) + 0.0
    tz = nz + 1 if z == "parity" else 2 * nz
    ty = ny + 1 if y == "parity" else 2 * ny
    if y == "folded":
        div = 3 * 2 * ny + 2 * tz + 5
        grd = 2 * tz + 3 * 2 * ny
    else:
        div = 3 * band + 2 * tz + ty + 5
        grd = 2 * tz + 2 * ty + 3 * band
    if stage == "x_div3":
        per_pt, fields = 3 * (nx + 1), 6
    elif stage == "x_gradsub3":
        per_pt, fields = 3 * (nx + 1) + 3, 9
    elif stage.startswith("div_solve"):
        per_pt, fields = div, 4
    elif stage.startswith("grad"):
        per_pt, fields = grd, 4
    else:
        per_pt = div + grd
        fields = 7 if stage.startswith("pressure_mid[q") else 6
    return 4 * npts * fields, npts * per_pt


def tiled_cost(stage, shape, w):
    """(bytes, flops) of one kernel of the y/z-tiled mid, counted as
    slab_cost counts the mid: t1 3 banded y applies (Iy du, Sy dv, Iy dw)
    and 2 forward y transforms (a, d), 3 fields in and 2 out; t2 2 forward
    z transforms (Iz a + Sz d), the solve and 2 inverse z transforms (Gzi,
    Gzs), 2 in and 3 out (q, p_z, dpdz_s); t3 2 inverse y transforms and 3
    banded y applies (Giy, Gsy, Giy), 2 in and 3 out. The three together do
    one forward y transform more than the merged mid (slab_cost's
    pressure_mid[q], the function's need): the tiled order's price."""
    nx, ny, nz = shape
    npts = nx * ny * nz
    band = 2 * (2 * w + 1) + 0.0
    per_pt = {1: 3 * band + 2 * (ny + 1),
              2: 2 * (nz + 1) + 5 + 2 * (nz + 1),
              3: 2 * (ny + 1) + 3 * band}[stage]
    return 4 * npts * 5, npts * per_pt


def carry_cost(shape, w, wp):
    """(bytes, flops) of stage C with the carry, counted as pipe_cost
    counts stage C but y first, as the function needs it: 2 inverse y
    transforms (Tyi X, Tyi Y) and 3 banded y applies at wp, or the 3
    inverse y transforms with the banded y folded in, whichever is
    cheaper (pipe_cost), 3 inverse z transforms (Gzi, Gzi, Gzs) and the
    subtraction; 5 fields in and 6 out (u', v', w' and the carried
    partials); per point and component the carry's 2w + 1 taps of D1, D2
    and D1d (at the w the kernel uses), the q*conv product and the
    combine."""
    nx, ny, nz = shape
    npts = nx * ny * nz
    band = 2 * (2 * wp + 1)
    per_pt = (min(2 * (ny + 1) + 3 * band, 3 * (ny + 1)) + 3 * (nz + 1) + 3
              + 3 * (2 * 3 * (2 * w + 1) + 1 + 5))
    return 4 * npts * (5 + 6), npts * per_pt


def x_parity_cost(shape, sub):
    """(bytes, flops) of one one-field parity x apply, counted as slab_cost
    counts x_div3 and x_gradsub3 per field: the field read once and the
    result written once (and s read once with the correction); n/2
    multiply-adds per output and the parity combine (and the
    subtraction)."""
    npts = shape[0] * shape[1] * shape[2]
    return 4 * npts * (3 if sub else 2), npts * (shape[0] + 1
                                                 + (1 if sub else 0))


def bf16_ulp(t):
    """One bfloat16 ulp at each value of the float32 tensor t: t = m 2^e,
    m in [0.5, 1), lies in the binade from 2^(e-1), where bfloat16's 7
    fraction bits step by 2^(e-8); 0 where t is 0."""
    import torch
    return torch.where(t == 0, torch.zeros_like(t),
                       torch.ldexp(torch.ones_like(t), t.frexp().exponent - 8))


def bf16_err(got, ref):
    """max |got - ref| over bfloat16 outputs, and the largest excess of
    |got - ref| over one bfloat16 ulp of ref, relative to max |ref| (NaN
    when not finite). A kernel whose float32 value is within the float32
    limit of the plain one rounds to RNE(plain) or to its neighbour: the
    excess is held to the float32 limit."""
    errs, excess = [], []
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        d = (g - r).abs()
        errs.append(float(d.max()))
        excess.append(float((d - bf16_ulp(r)).clamp(min=0).max()
                            / r.abs().max()))
    if not all(math.isfinite(x) for x in errs + excess):
        return math.nan, math.nan
    return max(errs), max(excess)


def dense_sweep_cost(shape, axis):
    """(bytes, flops) of one direction of the dense transport sweep: u, v,
    w read once, three RHS written once (the operators, 5 n^2 floats, are
    under 1% and left out); per point and component the three dense
    products (3 n multiply-adds), the q*conv product and the combine."""
    npts = shape[0] * shape[1] * shape[2]
    n = shape[axis]
    return 4 * npts * 6, npts * 3 * (2 * 3 * n + 1 + 5)


def x_apply_cost(n_out, n_in, ny, nz, sub):
    """(bytes, flops) of one dense x apply: f read once, out written once
    (and s read once with the correction), the operator read once; n_in
    multiply-adds per output (and the subtraction)."""
    cols = ny * nz
    nbytes = 4 * (cols * (n_in + n_out * (2 if sub else 1)) + n_out * n_in)
    return nbytes, cols * n_out * (2 * n_in + (1 if sub else 0))


def bound(nbytes, flops, tc=False):
    """(bound ms, its kind, bytes ms, operations ms): the function's
    bytes at the memory rate, its operations at the FP32 rate; tc: the
    split-TF32 x-apply kernel's, three TF32 products of every operation at
    the tensor cores' rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (3 * flops / PEAK_TF32 if tc else flops / PEAK_FP32) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations"), t_bytes, t_ops


def rel_err(got, ref):
    """max |got - ref| and the largest of max|got - ref| / max|ref| over
    the outputs; NaN when any of them is not finite (fails every check)."""
    errs, rels = [], []
    for g, r in zip(got, ref):
        d = float((g.to(r.dtype) - r).abs().max())
        errs.append(d)
        rels.append(d / float(r.abs().max()))
    if not all(math.isfinite(x) for x in errs + rels):
        return math.nan, math.nan
    return max(errs), max(rels)


def phi_variance(phi):
    """The scalars' variance, sum of phi^2 in float64 (their analogue of
    the kinetic energy)."""
    return float(phi.double().pow(2).sum())


def p_tolerance(p_ref, vel):
    """The bound on max |p - p_ref| for two float32 evaluations of the
    projection's pressure on one input: 1e-5 of max |p_ref|, plus four
    float32 roundings of the velocity. p solves lap p = div u', and in a
    step div u' is a small difference of O(max |u'|) terms (p is dt times
    the pressure: 3.75e-4 for TGV at dt = 1e-3, against max |u'| = 1), so
    a rounding eps * max |u'| anywhere in the chain moves p by that much
    over the lowest wavenumber, 1 in the 2 pi box, however small p is."""
    return p_tolerance_of(float(p_ref.abs().max()),
                          max(float(f.abs().max()) for f in vel))


def p_tolerance_of(p_max, vel_max):
    """p_tolerance from max |p_ref| and the largest max |u|, |v|, |w|."""
    return 1e-5 * p_max + 4 * 2.0 ** -24 * vel_max


# phase 8's solver parameters by name (SolverParams' keywords)
CHAIN_PARAMS = {
    "AB3": dict(Re=1600.0, time_intg="AB3", dt=DT),
    "AB3 + 2 species": dict(Re=1600.0, time_intg="AB3", dt=DT, n_species=2,
                            pr_species=PR),
    "AB3 compensated": dict(Re=1600.0, time_intg="AB3", dt=DT,
                            compensated=True),
    "AB3 compensated + 2 species": dict(Re=1600.0, time_intg="AB3", dt=DT,
                                       n_species=2, pr_species=PR,
                                       compensated=True),
    "RK3": dict(Re=1600.0, time_intg="RK3", dt=DT),
    "RK3 + 2 species": dict(Re=1600.0, time_intg="RK3", dt=DT, n_species=2,
                            pr_species=PR),
    # past the species sweeps' 8 scalars: x3d2_tpu's per-species einsums
    "AB3 + 9 species": dict(Re=1600.0, time_intg="AB3", dt=DT, n_species=9,
                            pr_species=tuple(0.5 + 0.1 * i
                                             for i in range(9)))}
# phase 8's chains at the tails' grids: the sweeps and the pipeline at an x
# tail (parity halves of 96), the slab on the folded y
TAIL_X_SMALL = (192, 128, 256)
TAIL_Y_SMALL = (128, 136, 128)
CHAIN_STEPS = 10
# steps of the chains whose CPU leg would set phase 8's wait: the carried
# chain at D640 (its plain pipeline at nz = 640 runs about 2.5 x 2.5 times a
# 128 x 128 x 256 step's work: points, z transform length) and the 9
# scalars at (128, 128, 256), whose dense per-species path took 578.1 s of
# one core for 10 steps (the run's longest leg by 280 s, on the host of an
# H100 80GB HBM3 at 700 W)
CHAIN_STEPS_LONG = 3
# processes computing phase 8's CPU legs while phases 3-7 run on the card
# (one torch and one BLAS thread each; the host has 8 cores, and the main
# process keeps one)
CPU_LEG_WORKERS = 7


def phase8_chains():
    """Phase 8's chains as data, in order: label; kind "tgv" on dims, or
    "cylinder" at CYL_SMALL (its parameters from its input file, with
    compensated); params (a CHAIN_PARAMS name); keep_pressure; the
    switches; the chain the case must take; nround, the bfloat16 stores a
    point feeds into u' a step (the history's, and the two partials'). The
    card legs' launch counts are main's."""
    b16 = {"X3D2_BF16_OLDS": "1"}
    acc16 = {"X3D2_BF16_ACC": "1"}
    xoff = {"X3D2_XDIV_FUSED": "0"}
    hi = {"X3D2_MATMUL_PRECISION": "highest"}
    d2c = {"X3D2_D2C": "1", **xoff}
    split = {"X3D2_MID_SPLIT": "1"}
    dense = {"X3D2_BFLY": "0"}

    def tgv(label, prm, keep, env, chain, nround=0, dims=SMALL):
        return dict(label=label, kind="tgv", dims=dims, params=prm,
                    keep=keep, env=env, chain=chain, nround=nround)

    def small(label, *a, **kw):
        return tgv(f"{SMALL} {label}", *a, **kw)

    def cyl(label, env, compensated, nsp=0):
        return dict(label=f"cylinder {size_label(CYL_SMALL)}{label}",
                    kind="cylinder", dims=CYL_SMALL, params=None,
                    compensated=compensated, keep=False, env=env,
                    chain="ab-unfused", nround=0, nsp=nsp)

    return [
        small("xdiv path", "AB3", False, {}, "xdiv"),
        small("keep_pressure=True", "AB3", True, {}, "xdiv"),
        small("X3D2_XDIV_FUSED=0", "AB3", False, xoff, "zxy"),
        small("AB3 + 2 species", "AB3 + 2 species", False, {}, "xdiv"),
        small("RK3 fused", "RK3", False, {}, "rk"),
        small("RK3 + 2 species (unfused)", "RK3 + 2 species", False, {},
              "rk-unfused"),
        tgv("TGV 128^3 (dense sweeps)", "AB3", False, {}, "ab-unfused",
            dims=(NT,) * 3),
        cyl("", {}, False),
        # the AB step's modes
        small("xdiv path, bfloat16 history", "AB3", False, b16, "xdiv", 1),
        small("xdiv path, bfloat16 partials", "AB3", False, acc16, "xdiv",
              2),
        small("xdiv path, bfloat16 history and partials", "AB3", False,
              {**b16, **acc16}, "xdiv", 3),
        small("X3D2_XDIV_FUSED=0, bfloat16 history", "AB3", False,
              {**b16, **xoff}, "zxy", 1),
        small("compensated + 2 species, bfloat16 history",
              "AB3 compensated + 2 species", False, b16, "ab-unfused", 1),
        small("X3D2_MERGED_X=0, keep_pressure=True, X3D2_XDIV_FUSED=0",
              "AB3", True, {"X3D2_MERGED_X": "0", **xoff}, "zxy"),
        cyl(" compensated", {}, True),
        # the HIGHEST mode
        small("HIGHEST, xdiv path", "AB3", False, hi, "xdiv"),
        small("HIGHEST, compensated", "AB3 compensated", False, hi,
              "ab-unfused"),
        small("HIGHEST, RK3 + 2 species (unfused)", "RK3 + 2 species",
              False, hi, "rk-unfused"),
        small("HIGHEST, xdiv path, bfloat16 history", "AB3", False,
              {**hi, **b16}, "xdiv", 1),
        small("HIGHEST, xdiv path, bfloat16 partials", "AB3", False,
              {**hi, **acc16}, "xdiv", 2),
        # the projection switches
        small("X3D2_D2C=1, X3D2_XDIV_FUSED=0", "AB3", False, d2c, "zxy"),
        small("X3D2_D2C=1, X3D2_XDIV_FUSED=0, HIGHEST", "AB3", False,
              {**d2c, **hi}, "zxy"),
        small("X3D2_D2C=1, X3D2_XDIV_FUSED=0, bfloat16 history", "AB3",
              False, {**d2c, **b16}, "zxy", 1),
        small("X3D2_MID_SPLIT=1, xdiv path", "AB3", False, split, "xdiv"),
        small("X3D2_MID_SPLIT=1, keep_pressure=True", "AB3", True, split,
              "xdiv"),
        small("X3D2_BFLY=0, keep_pressure=True", "AB3", True, dense, "zxy"),
        small("X3D2_BFLY=0, keep_pressure=False", "AB3", False, dense,
              "zxy"),
        small("X3D2_BFLY=0, compensated", "AB3 compensated", False, dense,
              "ab-unfused"),
        small("X3D2_MID_SPLIT=1, X3D2_BFLY=0, keep_pressure=True", "AB3",
              True, {**split, **dense}, "zxy"),
        small("X3D2_BFLY=0, X3D2_PIPE3=0", "AB3", False,
              {**dense, "X3D2_PIPE3": "0"}, "zxy"),
        cyl(" X3D2_MID_SPLIT=1", split, False),
        # the tails
        tgv(f"{TAIL_X_SMALL} x tail: the sweeps and the pipeline", "AB3",
            False, {}, "zxy", dims=TAIL_X_SMALL),
        tgv(f"{TAIL_Y_SMALL} folded y: the slab", "AB3", False, {},
            "ab-unfused", dims=TAIL_Y_SMALL),
        # PR 11: the carry's streamed form, and the scalars off the species
        # sweeps (x3d2_tpu's per-species einsums, plain PyTorch on the card)
        dict(tgv(f"{D640} X3D2_D2C=1: the streamed carry", "AB3", False,
                 d2c, "zxy", dims=D640), steps=CHAIN_STEPS_LONG),
        tgv("TGV 128^3 + 2 species (the v1 route, einsum scalars)",
            "AB3 + 2 species", False, {}, "ab-unfused", dims=(NT,) * 3),
        cyl(" + 1 scalar (einsum scalars)", {}, False, nsp=1),
        dict(small("AB3 + 9 species (einsum scalars)", "AB3 + 9 species",
                   False, {}, "xdiv"), steps=CHAIN_STEPS_LONG)]


def chain_label(short):
    """Phase 8's label of a chain CPU_SAME names: "cylinder" ones at
    CYL_SMALL, else TGV at SMALL."""
    if short.startswith("cylinder"):
        return f"cylinder {size_label(CYL_SMALL)}" + short[8:].replace(
            ",", "", 1)
    return f"{SMALL} {short}"


def chain_case(spec, device):
    """A phase 8 chain's case on `device` (the caller sets its switches)."""
    import numpy as np
    import torch
    from x3d2_tpu_torch import config
    from x3d2_tpu_torch.cases import SolverParams, TGVCase
    from x3d2_tpu_torch.common import BC
    from x3d2_tpu_torch.mesh import Mesh

    if spec["kind"] == "cylinder":
        cfg_ = config.Config.from_file(CYL_EXAMPLE)
        cfg_.domain.dims_global = CYL_SMALL
        cfg_.cylinder.inlet_noise = (0.0, 0.0, 0.0)
        cfg_.solver.compensated = spec["compensated"]
        nsp = spec.get("nsp", 0)
        if not nsp:
            return config.make_case(cfg_, monitor_path=None, verbose=False,
                                    keep_pressure=False, device=device)
        # the cylinder defines no scalars: the streamwise perturbation u - 1
        # as each scalar's initial field
        from x3d2_tpu_torch.cases import CylinderCase

        class CylinderScalars(CylinderCase):
            def initial_conditions(self):
                f = super().initial_conditions()
                f["phi"] = np.stack([f["u"] - 1.0] * nsp)
                return f

        cfg_.solver.n_species, cfg_.solver.pr_species = nsp, (0.7,) * nsp
        return CylinderScalars(Mesh.from_config(cfg_.domain), cfg_.solver,
                               dtype=torch.float32, monitor_path=None,
                               verbose=False, keep_pressure=False,
                               device=device, case_cfg=cfg_.cylinder)
    per = ((BC.PERIODIC, BC.PERIODIC),) * 3
    return TGVCase(Mesh(spec["dims"], (2 * math.pi,) * 3, per),
                   SolverParams(**CHAIN_PARAMS[spec["params"]]),
                   dtype=torch.float32, monitor_path=None, verbose=False,
                   keep_pressure=spec["keep"], device=device)


def chain_took(c):
    """The chain a case's step takes."""
    return ("rk" if c._fused_rk is not None
            else "rk-unfused" if c.ti.kind == "RK"
            else "ab-unfused" if c._fused_ab is None
            else "xdiv" if c._ab_is_xdiv else "zxy")


def cpu_leg(spec, out_dir):
    """A phase 8 chain's CPU leg (in a worker with one torch and one BLAS
    thread): after its steps (CHAIN_STEPS unless the spec names others),
    the .npy files of its state's float
    fields in out_dir (the fields go through files, not the pool's result
    pipe: unpickling a leg's 80 MB in the main process held its
    interpreter lock, and path PYB's host-clock step read ~240 ms instead
    of ~27 on an H100 80GB HBM3 at 700 W), the monitor's last KE, the
    chain it took, and R, the largest
    value stored in bfloat16 (the history's newest rhs; with nround > 1 also
    the z and x sweeps' partials of the final state; 0 without rounding),
    and its seconds."""
    import numpy as np
    import torch
    from x3d2_tpu_torch.common import env_set

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    with env_set(spec["env"]):
        c = chain_case(spec, "cpu")
        steps = spec.get("steps", CHAIN_STEPS)
        st = c.run(n_iters=steps, n_output=steps)
    rmax = 0.0
    if spec["nround"]:
        rmax = max(float(p_[0].float().abs().max()) for p_ in st["olds"])
        if spec["nround"] > 1:
            fab = c._fused_ab
            part = fab.sweeps[0](st["u"], st["v"], st["w"])
            rmax = max([rmax] + [float(t.float().abs().max()) for t in part])
            part = fab.sweeps[1](st["u"], st["v"], st["w"], acc=part)
            rmax = max([rmax] + [float(t.float().abs().max()) for t in part])
    stem = re.sub(r"[^A-Za-z0-9]+", "_", spec["label"])
    files = {}
    for k in ("u", "v", "w", "p", "phi"):
        if torch.is_tensor(st.get(k)):
            files[k] = os.path.join(out_dir, f"{stem}_{k}.npy")
            np.save(files[k], st[k].numpy())
    return (files, c.monitor.rows[-1][4], chain_took(c), rmax,
            time.perf_counter() - t0)


def start_cpu_legs(specs, shared, out_dir):
    """Phase 8's CPU legs, but those `shared` (CPU_SAME's first labels), on
    a pool of CPU_LEG_WORKERS spawned processes, each with one torch and
    one BLAS thread, their fields written to out_dir, the longest submitted
    first: (pool, {label: its pending result})."""
    import multiprocessing as mp

    from x3d2_tpu_torch.common import env_set

    os.makedirs(out_dir, exist_ok=True)
    with env_set({k: "1" for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                                   "OPENBLAS_NUM_THREADS")}):
        pool = mp.get_context("spawn").Pool(CPU_LEG_WORKERS)

    def cost(spec):
        # the longest legs first, so that no long one starts last and keeps
        # phase 8 waiting: RK3 runs three substages a step, the scalars'
        # sweeps and the HIGHEST mode's W = 32 sweeps about double a step
        prm = spec["params"] or ""
        npts = spec["dims"][0] * spec["dims"][1] * spec["dims"][2]
        # points and the z transforms' length past (128, 128, 256) (the
        # carry's leg at (128, 128, 640))
        big = max(1.0, spec.get("steps", CHAIN_STEPS) / CHAIN_STEPS * npts
                  / (SMALL[0] * SMALL[1] * SMALL[2])
                  * spec["dims"][2] / SMALL[2])
        return ((3 if prm.startswith("RK3") else 1)
                * (5 if "9 species" in prm else 2 if "species" in prm else 1)
                * (2 if "X3D2_MATMUL_PRECISION" in spec["env"] else 1) * big)

    legs = sorted((s for s in specs if s["label"] not in shared), key=cost,
                  reverse=True)
    return pool, {s["label"]: pool.apply_async(cpu_leg, (s, out_dir))
                  for s in legs}


def main():
    import numpy as np
    import torch

    t_start = time.perf_counter()
    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("no CUDA device: the chip smoke run needs a GPU",
              file=sys.stderr)
        return 2
    import x3d2_tpu_torch  # noqa: F401  (sets the fp32 matmul policy)
    from x3d2_tpu_torch import _build, config
    from x3d2_tpu_torch.cases import CylinderCase, SolverParams, TGVCase
    from x3d2_tpu_torch.common import BC, DataLoc, env_set
    from x3d2_tpu_torch.mesh import Mesh
    from x3d2_tpu_torch.ops import operator_apply as oa
    from x3d2_tpu_torch.ops import pressure_pipe as pp
    from x3d2_tpu_torch.ops import pressure_slab as sl
    from x3d2_tpu_torch.ops import species_sweep as spm
    from x3d2_tpu_torch.ops import transeq_dense as td
    from x3d2_tpu_torch.ops import transeq_sweep as ts
    from x3d2_tpu_torch.ops import x_apply_manual as xm
    from x3d2_tpu_torch.tools import prof_manual as pmt
    from x3d2_tpu_torch.tools import prof_xparity as pxp
    from x3d2_tpu_torch.ops.parity import (BW, Forms, ProjectionMats,
                                           build_projection_mats, pfwd, pinv,
                                           solve_factor)
    from x3d2_tpu_torch.solver import NavierStokes, transport_route
    from x3d2_tpu_torch.time_integrators import TimeIntegrator

    for switch in ("X3D2_XDIV_FUSED", "X3D2_FUSED_RK", "X3D2_FUSED_AB",
                   "X3D2_BF16_OLDS", "X3D2_BF16_ACC", "X3D2_MERGED_X",
                   "X3D2_PIPE3", "X3D2_BFLY", "X3D2_D2C",
                   "X3D2_MATMUL_PRECISION", "X3D2_PALLAS", "X3D2_MID_SPLIT",
                   "X3D2_CHUNK"):
        os.environ.pop(switch, None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls must be off")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision must be 'highest'")

    # ---- 2. build -------------------------------------------------------
    libs = _build.build_all(["transeq_sweep", "transeq_sweep_tc",
                             "transeq_sweep_w32", "pressure_pipe",
                             "pipe_c_d2", "transeq_dense",
                             "pressure_mid_tiled", "x_apply_manual"])
    ts._lib(16)
    ts._tc_lib()
    ts._lib(32)
    oa.lib()
    pp._carry_lib()
    td._lib()
    sl._tiled_lib()
    xm.lib()
    for name, lib in libs.items():
        print(f"[build] {lib.name}: {_build.BUILD_SECONDS[name]:.1f} s",
              flush=True)
        inst = ""
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            # ptxas names each instance by its mangled name and template
            # arguments: transeq_sweep_kernel<BS, W, AXIS, ACC, NOLDS, UPD,
            # BASE_SEP, PREC>, transeq_sweep_tc_kernel<AXIS, NOLDS,
            # BASE_SEP>, transeq_xdiv_kernel<BS, W, NOLDS, PREC>
            # (PREC: 1 a bfloat16 history, 2 bfloat16 partials),
            # species_sweep_kernel<BS, W, AXIS, ACC>, mat_apply_kernel<MODE,
            # TRANS, EPI, TWO, TAIL> (TAIL 0: the 128-tiled instances, 1:
            # the general ones),
            # pipe_c_d2_kernel<NZ>, transeq_dense_kernel<TRANS, EXACT>,
            # x_apply_tc_kernel<FORM, EPI, LINES>
            # (mangled: <length><name>; the length is checked, since the
            # anonymous namespace before the name may end in digits too)
            found = [m for m in re.finditer(
                r"(?=(\d+)([a-z][a-z0-9_]*_kernel)I((?:L[ib]\d+E)+)E)", line)
                if int(m.group(1)) == len(m.group(2))]
            if "C7518" in line:
                # serialised wgmma: the warning names its function
                print(f"[build {name}] " + line.strip())
            # the kernels that are no templates (mid_t1_kernel ... of
            # pressure_mid_tiled.cu, pipe_c_d2_streamed_kernel): the name
            # and then the parameters (pointers, or a struct in the
            # anonymous namespace)
            plain_k = [m for m in re.finditer(
                r"(?=(\d+)([a-z][a-z0-9_]*_kernel)E(?:P|NS_))", line)
                if int(m.group(1)) == len(m.group(2))]
            if found:
                inst = found[0].group(2) + "<" + ",".join(
                    re.findall(r"L[ib](\d+)E", found[0].group(3))) + ">"
            elif plain_k:
                inst = plain_k[0].group(2)
            elif "registers" in line or "spill" in line:
                # the halo forms: HALO, the last template argument, set
                halo = (" (halo form)" if inst.startswith(
                    ("transeq_sweep_kernel", "species_sweep_kernel"))
                    and inst.endswith(",1>") else "")
                print(f"[build {name} {inst}{halo}] " + line.strip())

    # the x-apply kernel's shared memory is dynamic: its S-stage ring
    print("[build x_apply_manual] x_apply_tc_kernel dynamic shared memory "
          "(the ring, the barriers), bytes: "
          + ", ".join(
              f"{tag} S={S} "
              f"{xm.geometry(form, n_o, k_, 512 * 512, 132, S).smem}"
              for tag, form, n_o, k_ in (
                  ("dense 512", xm.DENSE, 512, 512),
                  ("inv 512", xm.INV, 512, 256),
                  ("fwd 512", xm.FWD, 512, 256))
              for S in (2, 4, 6)), flush=True)

    def stamp(phase):
        print(f"[time] {phase} starts at {time.perf_counter() - t_start:.1f}"
              " s", flush=True)

    # phase 8's CPU legs, on the host while phases 3-7 use the card (the
    # legs CPU_SAME shares are not computed twice)
    chain_specs = phase8_chains()
    legs_dir = str(_build.BUILD_DIR.parent / "smoke_legs")
    cpu_pool, cpu_legs = start_cpu_legs(
        chain_specs, {chain_label(a) for a, _ in CPU_SAME}, legs_dir)

    # ---- 3. kernels vs plain ---------------------------------------------
    stamp("phase 3 (kernels vs plain)")
    per = ((BC.PERIODIC, BC.PERIODIC),) * 3
    nu = 1.0 / 1600
    nus = tuple(nu / pr for pr in PR)
    d64 = torch.float64
    ti = TimeIntegrator("AB3")
    rows = {}     # (kernel name, size label) -> its entry of the kernels line
    tc_names = set()   # sweeps held on the tensor-core body (ts.tc_route)

    def row(name, n, source, replaces, err, ms, plain_ms, cost,
            library_ms=None, tc=False):
        b, by, t_bytes, t_ops = bound(*cost, tc=tc)
        rows[name, n] = {"name": f"{name}@{n}", "route": "cuda",
                         "source": source, "replaces": replaces,
                         "launches": 0, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                         "library_ms": library_ms}
        if tc:
            return tc_txt(name, n, ms, cost, library_ms)
        lib_txt = ("" if library_ms is None
                   else f"  library {library_ms:.3f} ms")
        return f"bound {b:.3f} ms ({by}: bytes {t_bytes:.3f}, ops " \
               f"{t_ops:.3f}){lib_txt}"

    def tc_txt(name, n, ms, cost, library_ms):
        """The split-TF32 x-apply kernel's bound and share of one call,
        the FP32 bound and the library call beside them; a time below the
        bound fails (the bound would be wrong)."""
        b, by, t_bytes, t_ops = bound(*cost, tc=True)
        check(b <= ms, f"{name}@{n}: {ms:.4f} ms beats its bound {b:.4f}")
        lib_txt = ("" if library_ms is None else
                   f"  library {library_ms:.3f} ms (kernel/library "
                   f"{ms / library_ms:.2f})")
        return f"split-TF32 bound {b:.3f} ms ({by}: bytes {t_bytes:.3f}, " \
               f"3 x TF32 ops {t_ops:.3f}), share {b / ms:.0%}; FP32 bound " \
               f"{bound(*cost)[0]:.3f} ms{lib_txt}"

    def report(label, err32, rel32, rel64, ms, plain_ms, txt, lim64=3e-5,
               lim32=1e-5):
        print(f"[{label}] max|k-plain32|={err32:.3e} (rel {rel32:.2e} <= "
              f"{lim32:.3g})  rel vs plain64={rel64:.2e} (<= {lim64:g})  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  {txt}",
              flush=True)
        check(rel32 <= lim32, f"{label}: kernel vs plain f32 {rel32}")
        check(rel64 <= lim64, f"{label}: kernel vs plain f64 {rel64}")

    def to64(t):
        """A tensor, or a nest of tuples of tensors, in float64."""
        if t is None or torch.is_tensor(t):
            return None if t is None else t.to(d64)
        return tuple(to64(x) for x in t)

    def flat(res):
        out = []
        for x in res:
            out += [x] if torch.is_tensor(x) else flat(x)
        return out

    def cut_nest(x, cut):
        """A tensor, or a nest of tuples of tensors, cut (None kept)."""
        if x is None or torch.is_tensor(x):
            return None if x is None else cut(x).contiguous()
        return tuple(cut_nest(y, cut) for y in x)

    def hold(label, n, kern, plain, args, name, replaces, cost, again=False,
             source=SWEEP_SOURCE, lim64=3e-5, library=None, listed=True,
             fold=None, tail64=None, cut=None, tc=False):
        """Hold kern(*args) against plain(*args) in float32 and plain on
        the float64 args; time both (and `library`, one PyTorch call of the
        same function, where there is one). A name met before at this size
        (a second coefficient row, a second operator) adds its error to the
        first's entry. With again: a second launch must give the same bits.
        listed=False: held, kept out of the kernels line. fold: the outputs
        -> (float32 ones, bfloat16 ones); the float32 ones are held as
        above, the bfloat16 ones to one bfloat16 ulp of RNE(plain float32)
        plus the float32 limit (bf16_err). tail64=(k, lim): the last k
        float32 outputs are held to lim of plain float64 instead of lim64
        (the xdiv sweep's x-transformed divergence inputs in the HIGHEST
        mode: the projection's transforms, held to its 3e-5). cut: a
        function of a tensor (x planes 0 .. k of it, where the function
        acts along y or z alone) under which the kernel's outputs and the
        plain versions' inputs are compared, for grids whose plain float64
        version would not fit the card beside the kernel's (both are timed
        whole). tc: the split-TF32 x-apply kernel (its bound, row())."""
        reduced = fold is not None
        fold = fold or (lambda outs: (outs, []))
        if tc and name.startswith("transeq_sweep["):
            tc_names.add(name)
        got = flat(kern(*args))
        torch.cuda.synchronize()
        pargs = args
        if cut is not None:
            got = [cut(t).clone() for t in got]
            pargs = cut_nest(args, cut)
        if again:
            repeat = flat(kern(*args))
            torch.cuda.synchronize()
            check(all(torch.equal(g, h) for g, h in zip(got, repeat)),
                  f"{label}: two launches differ")
            del repeat
        g32, g16 = fold(got)
        p32, p16 = fold(flat(plain(*pargs)))
        err32 = rel32 = rel64 = 0.0
        tail_txt = ""
        if g32:
            err32, rel32 = rel_err(g32, p32)
            if cut is not None:
                del p32
                p32 = None
            p64 = fold(flat(plain(*to64(pargs))))[0]
            if tc and p32 is not None:
                # the split-TF32 kernel's distance to float64 beside plain
                # float32's own (not where a cut dropped plain float32's)
                tail_txt = (f"  plain32 vs plain64 rel "
                            f"{rel_err(p32, p64)[1]:.2e}")
            if tail64 is None:
                _, rel64 = rel_err(g32, p64)
            else:
                k, lim_t = tail64
                _, rel64 = rel_err(g32[:-k], p64[:-k])
                _, rel_t = rel_err(g32[-k:], p64[-k:])
                tail_txt = (f"  last {k} outputs vs plain64 rel {rel_t:.2e} "
                            f"(<= {lim_t:g})")
                check(rel_t <= lim_t, f"{label} {n}: the last {k} outputs "
                                      f"vs plain f64 {rel_t}")
            del p64
        err16, ex16 = bf16_err(g16, p16) if g16 else (0.0, 0.0)
        del got, g32, g16, p32, p16, pargs
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kern(*args), 10, torch)
        plain_ms = cuda_ms(lambda: plain(*args), 5, torch)
        lib_ms = None if library is None else cuda_ms(lambda: library(*args),
                                                      10, torch)
        err = max(err32, err16)
        if (name, n) in rows:   # the startup row: the steady one's times
            rows[name, n]["max_abs_err"] = max(err,
                                               rows[name, n]["max_abs_err"])
            txt = tc_txt(name, n, ms, cost, lib_ms) if tc else ""
        else:
            txt = row(name, n, source, replaces, err, ms, plain_ms, cost,
                      lib_ms, tc)
            if not listed:
                del rows[name, n]
        txt += tail_txt
        if reduced:
            txt += (f"  bfloat16 outputs: max|k-RNE(plain32)|={err16:.3e}, "
                    f"beyond one ulp rel {ex16:.2e} (<= 1e-5)")
        report(f"{label} {n}", err32, rel32, rel64, ms, plain_ms, txt, lim64)
        check(ex16 <= 1e-5, f"{label} {n}: bfloat16 outputs {ex16} beyond "
                            "one ulp of RNE(plain f32)")

    def sweep_fold(dtc, xm, upd, olds_bf16, acc_bf16):
        """The fold of a reduced-precision sweep's outputs (hold). Without
        the update the bfloat16 partials are the outputs. With a bfloat16
        history u' carries dtc4 (r - RNE(r)), and where kernel and plain
        round r to neighbouring bfloat16 values (their float32 r differ in
        the last bits) u' differs by dtc4 times that ulp: u' + dtc4 RNE(r)
        (and du, dv, dw plus the forward parity x apply of it) is free of
        that rounding, and is held as a float32 output; RNE(r) itself is
        held as a bfloat16 one."""
        if not upd:
            return (lambda outs: ([], outs)) if acc_bf16 else None
        if not olds_bf16:
            return None

        def fold(outs):
            new, rhs, divs = outs[:3], outs[3:6], outs[6:]
            add = [dtc[4] * r.to(new[0].dtype) for r in rhs]
            out = [q + a for q, a in zip(new, add)]
            if divs:
                sx, ix = xm.mats(new[0].dtype)
                out += [d + pfwd(M, a, 0)
                        for d, M, a in zip(divs, (sx, ix, ix), add)]
            return out, list(rhs)

        return fold

    def sweep_rows(shape, ops, variants, randn, terms=2, listed=True):
        """Hold sweep variants (label, axis, kw: acc, olds, dtc, xdiv,
        base, acc_dtype) against the plain version at `shape`, built at
        the geometry of `terms` (3: the HIGHEST mode's W = 32 instances,
        held to 5e-7 of plain float64, the bound of x3d2_tpu's HIGHEST
        kernels, tests/test_pallas_v3.py:114; their xdiv outputs du, dv,
        dw, the projection's transforms of u', to its 3e-5)."""
        u, v, w = randn(), randn(), randn()
        n = size_label(shape)
        for label, axis, kw in variants:
            blocks = ts.build_sweep_blocks(ops[axis], axis, device=dev,
                                           terms=terms)
            a, o, dtc = kw.get("acc"), kw.get("olds"), kw.get("dtc")
            xm, base = kw.get("xdiv"), kw.get("base")
            adt, cut = kw.get("acc_dtype"), kw.get("cut")
            nolds = len(o[0]) if o is not None else 0
            ob = nolds > 0 and o[0][0].dtype == torch.bfloat16
            ab = adt == torch.bfloat16

            def kern(u, v, w, a, o, base):
                return ts.transeq_sweep(u, v, w, blocks, nu, acc=a, olds=o,
                                        dtc=dtc, xdiv=xm, base=base,
                                        acc_dtype=adt)

            def plain(u, v, w, a, o, base):
                return ts.transeq_sweep_plain(u, v, w, blocks, nu, acc=a,
                                              olds=o, dtc=dtc, xdiv=xm,
                                              base=base, acc_dtype=adt)

            upd, sep = dtc is not None, base is not None
            w32 = blocks.w != ts.W
            # the tensor-core body (every W = 16 sweep but xdiv): its bound
            # the split-TF32 one, the FP32 one beside it
            tc = ts.tc_route(blocks, xm)
            hold(f"sweep {label}{' w32' if w32 else ''}", n, kern, plain,
                 (u, v, w, a, o, base),
                 ts.variant_name(axis, a is not None, nolds, xm is not None,
                                 upd, sep, ob, ab, w=blocks.w),
                 REPLACES[axis],
                 sweep_cost(shape, a is not None, nolds, blocks.w,
                            xm is not None, upd, sep, ob, ab),
                 again=xm is not None,
                 fold=sweep_fold(dtc, xm, upd, ob, ab),
                 source=(SWEEP32_SOURCE if w32 else SWEEP_TC_SOURCE if tc
                         else SWEEP_SOURCE),
                 lim64=5e-7 if w32 else 3e-5,
                 tail64=(3, 3e-5) if w32 and xm is not None else None,
                 cut=cut, tc=tc, listed=listed)

    def bf16_variants(randn, xm=None):
        """The reduced-precision sweeps of the fused AB chain (paths H, HP
        and HA), or with xm of the xdiv chain: the z sweep and the
        accumulate sweep with bfloat16 partials, then the final sweep with a
        bfloat16 history alone, with bfloat16 partials alone and with both,
        each on the steady row and a startup one."""
        b = torch.bfloat16
        acc32 = tuple(randn(100.0) for _ in range(3))
        acc16 = tuple(t.to(b) for t in acc32)
        olds32 = tuple(tuple(randn(100.0) for _ in range(2))
                       for _ in range(3))
        olds16 = tuple(tuple(t.to(b) for t in o) for o in olds32)
        mid, fin = (1, 0) if xm is not None else (0, 1)
        tag = "x,acc,ab3,xdiv" if xm is not None else "y,acc,ab3"
        out = [("z,bf16acc", 2, {"acc_dtype": b}),
               (f"{'xy'[mid]},acc,bf16acc", mid, {"acc": acc16,
                                                  "acc_dtype": b})]
        for sfx, olds, acc, adt in ((",bf16olds", olds16, acc32, None),
                                    (",bf16acc", olds32, acc16, b),
                                    (",bf16olds,bf16acc", olds16, acc16, b)):
            for rname, istep in (("steady", 3), ("startup", 1)):
                out.append((f"{tag}{sfx} {rname}", fin,
                            {"acc": acc, "olds": olds, "acc_dtype": adt,
                             "xdiv": xm,
                             "dtc": ti.ab_row(istep, DT,
                                              feedback=olds is olds16)}))
        return out

    def parity_rows(shape, pm, randn, stages, listed=True):
        """The one-field parity x applies (stages among x_pfwd, x_pinv,
        x_pinv[sub]: the split-TF32 x-apply kernel of MANUAL_SOURCE on
        pm's operators packed in their parity forms) against their plain
        version, within TC_LIM of plain float64, beside one torch.matmul
        (torch.addmm with the correction) of the dense nx x nx operator the
        parity split stands for, in block-parity order, over the field as
        an (nx, ny nz) matrix; two launches, and S = 2, 3, 6 against S = 4,
        bit-equal. Each row also prints the launch's device ms back to back
        and its host µs a call, and the call's device ms
        (tools/prof_xparity.py). listed=False: held, kept out of the
        kernels line."""
        n = size_label(shape)
        nx = shape[0]
        eye = torch.eye(nx, dtype=d64, device=dev).unsqueeze(-1)
        for stage in stages:
            ops_ = ("sx", "ix") if stage == "x_pfwd" else ("gxs", "gxi")
            sub = stage == "x_pinv[sub]"
            for op in ops_:
                args = (randn(), randn() if sub else None)
                dense = sl.x_apply_parity_plain(
                    op, pm.mats(d64)[op], eye).squeeze(-1).float()

                def kern(f, s_, op=op):
                    return (sl.x_apply_parity(op, f, pm, s_),)

                def plain(f, s_, op=op):
                    return (sl.x_apply_parity_plain(op, pm.mats(f.dtype)[op],
                                                    f, s_),)

                def library(f, s_, dense=dense):
                    f2 = f.reshape(nx, -1)
                    r = (torch.matmul(dense, f2) if s_ is None else
                         torch.addmm(s_.reshape(nx, -1), dense, f2,
                                     alpha=-1.0))
                    return r.reshape(f.shape)

                hold(f"{stage}[{op}]", n, kern, plain, args, stage,
                     REPLACES[stage], x_parity_cost(shape, sub), again=True,
                     source=MANUAL_SOURCE, library=library, listed=listed,
                     tc=True, lim64=TC_LIM)
                packed = pm.packed_x(op)
                ref = kern(*args)[0]
                for S in (2, 3, 6):
                    check(torch.equal(xm.launch(stage, packed, *args,
                                                slots=S), ref),
                          f"{stage}[{op}] {n}: S = {S} differs from S = 4")
                del ref
                geo = xm.geometry(packed.form, packed.n_out, packed.K,
                                  shape[1] * shape[2],
                                  torch.cuda.get_device_properties(
                                      dev).multi_processor_count)
                print(f"[{stage}[{op}] {n}] S = 2, 3, 6 bit-equal to S = 4;"
                      f" device {pxp.device_ms(lambda: kern(*args), 20):.4f}"
                      f" ms back to back, host "
                      f"{pxp.host_us(lambda: kern(*args), 20):.1f} µs a "
                      f"call; the call's device "
                      f"{pxp.device_ms(lambda: library(*args), 20):.4f} ms;"
                      f" {geo.nitems} items", flush=True)

    def species_rows(shape, ops, randn, terms=2):
        """The species sweeps of the two scalars, z; x + acc; y + acc (at
        the geometry of `terms`, as sweep_rows)."""
        phis = (randn(), randn())
        comps = (randn(), randn(), randn())
        acc = (randn(100.0), randn(100.0))
        for axis, a in ((2, None), (0, acc), (1, acc)):
            blocks = ts.build_sweep_blocks(ops[axis], axis, device=dev,
                                           terms=terms)

            def kern(phis, conv, a):
                return spm.species_sweep(phis, conv, blocks, nus, acc=a)

            def plain(phis, conv, a):
                return spm.species_sweep_plain(phis, conv, blocks, nus, acc=a)

            name = spm.variant_name(axis, a is not None, blocks.w)
            w32 = blocks.w != ts.W
            hold(name, size_label(shape), kern, plain,
                 (phis, comps[axis], a), name, REPLACES["species"],
                 species_cost(shape, len(nus), a is not None, blocks.w),
                 source=SWEEP32_SOURCE if w32 else SWEEP_SOURCE,
                 lim64=5e-7 if w32 else 3e-5)

    def stage_row(name, ins, kern_fn, plain_fn, cost, pm, on_path=True,
                  n=None, source=PIPE_SOURCE, derive64=False):
        """Hold one function of a projection (operator set `pm`) against
        its plain version on `ins`. on_path=False: a size no path gives the
        function, held but left out of the kernels line. n: the size label
        (default: of the first input). derive64: the limit against plain
        float64 is twice plain float32's own distance to it on these inputs
        (the white-noise rule), and not below 3e-5. The stages of PIPE_TC
        run on MANUAL_SOURCE's split-TF32 kernel: launched twice, bit-equal,
        their bound the split-TF32 one (row(tc=True)) with plain float32's
        own distance to float64 printed beside theirs."""
        m32, m64 = pm.mats(torch.float32), pm.mats(d64)
        n = n or size_label(ins[0].shape)
        tc = name in PIPE_TC
        if tc:
            source = MANUAL_SOURCE
        got = [t for t in kern_fn(*ins, pm) if t is not None]
        torch.cuda.synchronize()
        if tc:
            again = [t for t in kern_fn(*ins, pm) if t is not None]
            torch.cuda.synchronize()
            check(all(torch.equal(g, h) for g, h in zip(got, again)),
                  f"{name} {n}: two launches differ")
            del again
        p32 = [t for t in plain_fn(*ins, m32) if t is not None]
        err32, rel32 = rel_err(got, p32)
        p64 = [t for t in plain_fn(*to64(ins), m64) if t is not None]
        _, rel64 = rel_err(got, p64)
        lim64 = 3e-5
        own64 = rel_err(p32, p64)[1]
        if derive64:
            lim64 = max(3e-5, 2 * own64)
        del got, p32, p64
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kern_fn(*ins, pm), 10, torch)
        plain_ms = cuda_ms(lambda: plain_fn(*ins, m32), 5, torch)
        txt = row(name, n, source, REPLACES[name], err32, ms, plain_ms, cost,
                  tc=tc)
        if tc:
            txt += f"  two launches bit-equal; plain32 vs plain64 rel " \
                   f"{own64:.2e}"
        if not on_path:
            del rows[name, n]
        report(f"{name} {n}", err32, rel32, rel64, ms, plain_ms, txt, lim64)

    def pipe_rows(shape, fields, pm, on_path=True):
        """The pipeline's stages at `shape`, each on the inputs the
        previous stage's plain version gives (so kernel and plain see the
        same tensors); on a path's size also each launch of the stages
        (tc_launches). on_path=False: held, left out of the kernels
        line."""
        u, v, w = fields
        m32 = pm.mats(torch.float32)
        a_, e_ = pp.pipe_a_plain(u, v, w, m32)
        X_, Y_ = pp.pipe_b_plain(a_, e_, m32)
        for name, ins, kern_fn, plain_fn in [
                ("pipe_a", (u, v, w), pp.pipe_a, pp.pipe_a_plain),
                ("pipe_b", (a_, e_), pp.pipe_b, pp.pipe_b_plain),
                ("pipe_c", (X_, Y_, u, v, w), pp.pipe_c, pp.pipe_c_plain)]:
            stage_row(name, ins, kern_fn, plain_fn,
                      pipe_cost(name, shape, BW), pm, on_path)
        if on_path:
            tc_launches(shape, fields, (a_, e_), (X_, Y_), pm)
        del a_, e_

    def tc_launches(shape, fields, ae, xy, pm):
        """Each launch of the stages (A and C: the z and the y launch of
        MANUAL_SOURCE's kernel; B: the x FWD launch with the solve and the
        x INV launch) at `shape`, on the stages' inputs: its time in a
        single call, back to back and the host's µs a call
        (tools/prof_xparity.py's timings), its split-TF32 bound with the
        FP32 one beside it, and as a yardstick one torch.matmul
        (torch.baddbmm with the subtraction) of the dense operators its
        parity applies stand for, batched over its jobs' sources (the sums
        of e's and of q's two sources left out, and the solve). B's INV
        launch is held to TC_LIM of plain float64 on its own input."""
        n = size_label(shape)
        op = pp.tc_ops(pm, dev)
        u, v, w = fields
        a, e = ae
        X, Y = xy
        nx, ny, nz = shape
        m64, fold = pm.mats(d64), pp.fold_y(pm)

        def dense(name, fwd):
            M = (m64[name] if name in m64 else
                 torch.as_tensor(fold[name], dtype=d64, device=dev))
            eye = torch.eye(2 * M.shape[1], dtype=d64,
                            device=dev).unsqueeze(-1)
            return (pfwd(M, eye, 0) if fwd else
                    pinv(M, eye, 0)).squeeze(-1).float()

        z = pp.pipe_a_z(u, v, w, op)
        g = pp.pipe_c_z(X, Y, op)
        tabs = pp.solve_tables(pm)
        q = pp.pipe_b_x(a, e, op, tabs)
        got = pp.pipe_b_inv(q, op)
        q64 = q.to(d64)
        rel_inv = max(rel_err([g_], [pinv(m64[k], q64, 0)])[1]
                      for g_, k in zip(got, ("gxs", "gxi")))
        del got, q64
        print(f"[pipe_b x inv launch {n}] vs plain64 on its own input rel "
              f"{rel_inv:.2e} (<= {TC_LIM:g})", flush=True)
        check(rel_inv <= TC_LIM, f"pipe_b's INV launch at {n}: {rel_inv} "
                                 "of plain f64")
        Dx = torch.stack([dense(k, k in ("sx", "ix")) for k in
                          ("sx", "ix", "gxs", "gxi")])
        xs = torch.stack([a, e]).reshape(2, nx, -1)
        qs = q.reshape(1, nx, -1)
        Dz = torch.stack([dense(k, k in ("iz", "sz")).T for k in
                          ("iz", "iz", "sz", "gzi", "gzs", "gzi")])
        Dy = torch.stack([dense(k, k in ("tyI", "tyS")) for k in
                          ("tyI", "tyS", "tyI", "giT", "gsT", "giT")])
        zf = torch.stack([t.reshape(-1, nz) for t in (u, v, w)])
        gf = torch.stack([t.reshape(-1, nz) for t in (X, Y, Y)])
        ys = torch.stack(z)
        yg = torch.stack([g[0], g[2], g[1]]).reshape(-1, ny, nz)
        ss = torch.stack([u, v, w]).reshape(-1, ny, nz)
        Dyi = Dy[3:, None].expand(3, nx, ny, ny).reshape(-1, ny, ny)
        launches = [
            ("pipe_a", "z", lambda: pp.pipe_a_z(u, v, w, op),
             lambda: torch.matmul(zf, Dz[:3]), 6, 3 * (nz + 1)),
            ("pipe_a", "y", lambda: pp.pipe_a_y(*z, op),
             lambda: torch.matmul(Dy[:3, None], ys), 5, 3 * (ny + 1) + 1),
            ("pipe_b", "x fwd", lambda: pp.pipe_b_x(a, e, op, tabs),
             lambda: torch.matmul(Dx[:2], xs), 3, 2 * (nx + 1) + 5),
            ("pipe_b", "x inv", lambda: pp.pipe_b_inv(q, op),
             lambda: torch.matmul(Dx[2:], qs), 3, 2 * (nx + 1)),
            ("pipe_c", "z", lambda: pp.pipe_c_z(X, Y, op),
             lambda: torch.matmul(gf, Dz[3:]), 5, 3 * (nz + 1)),
            ("pipe_c", "y", lambda: pp.pipe_c_y(*g, u, v, w, op),
             lambda: torch.baddbmm(ss, Dyi, yg, alpha=-1.0), 9,
             3 * (ny + 1) + 3)]
        npts = nx * ny * nz
        for stage, axis, kern, library, nfields, per_pt in launches:
            cost = (4 * npts * nfields, npts * per_pt)
            ms = cuda_ms(kern, 10, torch)
            lib_ms = cuda_ms(library, 10, torch)
            print(f"[{stage} {axis} launch {n}] single {ms:.4f} ms, device "
                  f"{pxp.device_ms(kern, 20):.4f} ms back to back, host "
                  f"{pxp.host_us(kern, 20):.1f} µs a call; "
                  f"{tc_txt(f'{stage}[{axis}]', n, ms, cost, lib_ms)}",
                  flush=True)
        del z, g, Dz, Dy, zf, gf, ys, yg, ss, Dyi, q, Dx, xs, qs
        torch.cuda.empty_cache()

    # the slab projection's functions. Their inputs are a few plane waves
    # of wavenumber about 12 in y and 1-2 in x and z, not white noise: the
    # mid solves (divides by k^2) and differentiates the result in y
    # through a physical-space intermediate. Under white noise the float32
    # rounding of all modes lands on the k = 1 modes that carry max |q|
    # (the plain float32 version then differs from the float64 one by
    # about 2e-5 at 512^3); under a smooth k = 1 field the y derivative of
    # p cancels to 1/(k dy) digits (4e-5). A mid-band field keeps both
    # below the limits, for the kernel and for the plain version alike.
    # White noise is held as well, against what the plain float32 version
    # itself reaches there (mid_on_noise below).
    def wave_fields(mesh_, k=12):
        # coordinates scaled to a 2 pi box (the identity on the TGV box)
        X, Y, Z = (torch.as_tensor(g * (2 * math.pi / L_), dtype=torch.float32,
                                   device=dev)
                   for g, L_ in zip(mesh_.coord_grids(DataLoc.VERT), mesh_.L))
        return (torch.sin(X) * torch.cos(k * Y) * torch.cos(Z)
                + 0.5 * torch.cos(2 * X + (k - 1) * Y),
                torch.cos(X) * torch.sin(k * Y) * torch.cos(2 * Z)
                + 0.3 * torch.sin((k - 2) * Y + Z),
                torch.cos(2 * X) * torch.cos((k - 1) * Y) * torch.sin(Z)
                + 0.2 * torch.sin(X + k * Y + 2 * Z))

    def mid_q(du, dv, dw, m):
        return sl.pressure_mid(du, dv, dw, m, emit_q=True)

    def mid_nq(du, dv, dw, m):
        return sl.pressure_mid(du, dv, dw, m, emit_q=False)

    def mid_q_plain(du, dv, dw, m, forms=Forms()):
        return sl.pressure_mid_plain(du, dv, dw, m, True, forms)

    def mid_nq_plain(du, dv, dw, m, forms=Forms()):
        return sl.pressure_mid_plain(du, dv, dw, m, False, forms)

    def div_solve_k(du, dv, dw, pm):
        return (sl.div_solve(du, dv, dw, pm),)

    def div_solve_p(du, dv, dw, m, forms=Forms()):
        return (sl.div_solve_plain(du, dv, dw, m, forms),)

    def slab_rows(shape, mesh_, pm, on_path, n=None):
        """The mid with and without q and its halves (div_solve, grad), in
        pm's forms, and on a periodic x x_div3 and x_gradsub3, at `shape`
        on plane waves; the names in `on_path` enter the kernels line, at
        the size label n (default: of the shape). The mid without q gives
        the bits of the mid with q, and the halves give them too."""
        m32 = pm.mats(torch.float32)
        su, sv, sw = wave_fields(mesh_)
        dp = tuple(t.contiguous() for t in div_plain((su, sv, sw), m32, pm))
        qp = sl.div_solve_plain(*dp, m32, pm.forms).contiguous()
        gp = tuple(t.contiguous()
                   for t in sl.grad_plain(qp, m32, pm.forms))
        form = {"forms": pm.forms}
        jobs = [(sl.stage_name("pressure_mid", pm, True), dp, mid_q,
                 partial(mid_q_plain, **form)),
                (sl.stage_name("pressure_mid", pm), dp, mid_nq,
                 partial(mid_nq_plain, **form)),
                (sl.stage_name("div_solve", pm), dp, div_solve_k,
                 partial(div_solve_p, **form)),
                (sl.stage_name("grad", pm), (qp,), sl.grad,
                 partial(sl.grad_plain, **form))]
        if pm.x_perm is not None:
            jobs = [("x_div3", (su, sv, sw), sl.x_div3, sl.x_div3_plain)] \
                + jobs + [("x_gradsub3", gp + (su, sv, sw), sl.x_gradsub3,
                           sl.x_gradsub3_plain)]
        for name, ins, kern_fn, plain_fn in jobs:
            stage_row(name, ins, kern_fn, plain_fn,
                      slab_cost(name, pm.shape, BW, pm.forms.y,
                                pm.forms.z), pm, name in on_path, n=n)
        with_q, no_q = mid_q(*dp, pm), mid_nq(*dp, pm)
        q = sl.div_solve(*dp, pm)
        halves = (q,) + sl.grad(q, pm)
        check(no_q[0] is None and with_q[0] is not None
              and all(torch.equal(a, b)
                      for a, b in zip(with_q[1:], no_q[1:]))
              and all(torch.equal(a, b) for a, b in zip(with_q, halves)),
              "the mid without q and the mid's halves must give the bits "
              "of the mid with q")
        print(f"[{sl.stage_name('pressure_mid', pm)} "
              f"{n or size_label(shape)}] without q: p_zy, dpdy, dpdz "
              "bit-equal to the mid with q; div_solve then grad: q, p_zy, "
              "dpdy, dpdz bit-equal to it", flush=True)

    def div_plain(fields, m, pm):
        """The mid's inputs from velocities: the parity x stage, or the
        dense x applies on a wall-bounded x."""
        if pm.x_perm is not None:
            return sl.x_div3_plain(*fields, m)
        return (sl.x_apply_plain(m["sx"], fields[0]),
                sl.x_apply_plain(m["ix"], fields[1]),
                sl.x_apply_plain(m["ix"], fields[2]))

    def mid_on_noise(shape, pm, fields, label, hold, batch=None):
        """The mid with q on the x_div3 of `fields`: kernel, plain float32
        and plain float64 (batch=(off, n): the tiled mid over the x batch
        [off, off + n) of the x-transformed fields, with its table slices,
        against its plain version). Printed; with `hold` (white noise) also
        held:
        - q times its wave factor is the solve's input F, mode by mode,
          without the division by k^2 that lets a few k = 1 modes carry
          max |q|: the usual limits, 1e-5 of plain float32 and 3e-5 of
          plain float64, relative to max |F|. White noise fills every mode,
          so every entry of the solve tables is read and compared.
        - each output, unweighted: the kernel may be no worse a float32
          evaluation than the plain version. The template's launches are
          bit-equal to their plain versions on equal inputs (a two-source
          launch sums each source apart and adds the two sums, as plain
          does) but the solve, by a fused multiply-add
          (x3d2_tpu_torch/tools/mid_probe.py shows each launch, and the
          whole mid over 12 seeds at 1.00x); the tiled kernels order their
          sums otherwise. Two independent float32 roundings of one size
          differ by sqrt(2) of either one's distance to float64 in the
          mean: the root-mean-square differences kernel - plain32 and
          kernel - plain64 are held to 2x the root-mean-square plain32 -
          plain64 of the same run. The maxima sit on a handful of k = 1
          modes and scatter between seeds (the probe prints several):
          held to 4x."""
        m32, m64 = pm.mats(torch.float32), pm.mats(d64)
        ins = tuple(t.contiguous() for t in div_plain(fields, m32, pm))
        name_q, shape_q = sl.stage_name("pressure_mid", pm, True), pm.shape
        lab_q = size_label(shape)
        if batch is None:
            kern = [t.to(d64) for t in mid_q(*ins, pm)]
            plain32 = [t.to(d64) for t in mid_q_plain(*ins, m32, pm.forms)]
            plain64 = mid_q_plain(*to64(ins), m64, pm.forms)
        else:
            off, n_b = batch
            ins = tuple(t[off:off + n_b].contiguous() for t in ins)
            m32 = sl.local_tables(m32, off, n_b)
            m64 = sl.local_tables(m64, off, n_b)
            kern = [t.to(d64) for t in sl.pressure_mid_tiled(
                *ins, pm, m32["k2x"], m32["tx2"], m32.get("mx"))]
            plain32 = [t.to(d64)
                       for t in sl.pressure_mid_tiled_plain(*ins, m32)]
            plain64 = sl.pressure_mid_tiled_plain(*to64(ins), m64)
            name_q, shape_q = "pressure_mid[tiled]", tuple(ins[0].shape)
            lab_q = size_label(shape_q)

        def dist(a, b, weight=None):
            d = (a - b) if weight is None else (a - b) * weight
            return float(d.abs().max()), float(d.pow(2).mean().sqrt())

        tag = f"{name_q} {lab_q} on {label}"
        for name, k, p32, p64 in zip(("q", "p_zy", "dpdy", "dpdz"), kern,
                                     plain32, plain64):
            kp, k6, p6 = dist(k, p32), dist(k, p64), dist(p32, p64)
            scale = float(p64.abs().max())
            lim = ("(<= 2)", "(<= 4)") if hold else ("", "(not held)")
            print(f"[{tag}] {name}: max kernel-plain32 {kp[0] / scale:.2e} "
                  f"kernel-plain64 {k6[0] / scale:.2e} plain32-plain64 "
                  f"{p6[0] / scale:.2e} (of max |plain64|); rms "
                  f"{kp[1] / p6[1]:.2f}x and {k6[1] / p6[1]:.2f}x the "
                  f"plain32-plain64 one {lim[0]}, max {kp[0] / p6[0]:.2f}x "
                  f"and {k6[0] / p6[0]:.2f}x {lim[1]}", flush=True)
            if hold:
                check(kp[1] <= 2 * p6[1] and k6[1] <= 2 * p6[1],
                      f"{tag}: {name} rms {kp[1]}, {k6[1]} vs {p6[1]}")
                check(kp[0] <= 4 * p6[0] and k6[0] <= 4 * p6[0],
                      f"{tag}: {name} max {kp[0]}, {k6[0]} vs {p6[0]}")
        if hold:
            factor = solve_factor(m64, tuple(shape_q)).abs()
            waves = torch.where(factor > 0, 1.0 / factor, factor)
            scale = float((plain64[0] * waves).abs().max())
            f32 = dist(kern[0], plain32[0], waves)[0] / scale
            f64 = dist(kern[0], plain64[0], waves)[0] / scale
            print(f"[{tag}] q times its wave factor (the solve's input, "
                  f"every mode): kernel vs plain f32 rel {f32:.2e} (<= "
                  f"1e-5), vs plain f64 rel {f64:.2e} (<= 3e-5)", flush=True)
            check(f32 <= 1e-5 and f64 <= 3e-5,
                  f"{tag}: weighted q {f32}, {f64}")

    def tiled_rows(gdims, pm, off_x, nx_loc, on_path):
        """The y/z-tiled mid's three kernels over the x batch [off_x, off_x
        + nx_loc) of the grid gdims (the solve tables sliced there), each
        on the inputs the previous kernel's plain version gives, the first
        on the batch of the x-transformed plane waves (as slab_rows); then
        the three in turn against the plain tiled mid: within 1e-5 of
        plain float32, and of plain float64 within 3e-5, or 6e-5 on planes
        of 1024 points along y or z, whose transforms put the plain float32
        version itself 4.37e-5 from plain float64 (and the kernels
        4.33e-5: PERF.md section 6), so that no float32 evaluation meets
        3e-5 there; on planes of 2048 points and more along y or z (the
        kernels' long form) each kernel and the three in turn within twice
        plain float32's own distance to plain float64 on the same inputs
        in this run (the white-noise rule), not below 3e-5, and the three
        in turn within that of plain float32 too (two float32 evaluations
        of transforms 2048 long differ by about their distance to float64:
        1.76e-5 at 32 x 2048 x 256, plain float32 3.63e-5 from float64, on
        an H100 80GB HBM3 at 700 W), not below 1e-5; then on white
        noise (mid_on_noise, which follows). on_path: the batch is a path's
        (phase 9), else the kernels are held, not listed."""
        m32 = pm.mats(torch.float32)
        lm32 = sl.local_tables(m32, off_x, nx_loc)
        lm64 = sl.local_tables(pm.mats(d64), off_x, nx_loc)
        tabs = (lm32["k2x"], lm32["tx2"], lm32.get("mx"))
        mesh_g = Mesh(gdims, (2 * math.pi,) * 3, per)
        dp = tuple(t[off_x:off_x + nx_loc].contiguous()
                   for t in div_plain(wave_fields(mesh_g), m32, pm))
        shape_b = tuple(dp[0].shape)
        n = size_label(shape_b)
        a_, d_ = (t.contiguous() for t in sl.mid_t1_plain(*dp, m32))
        _, pz_, dz_ = (t.contiguous() for t in sl.mid_t2_plain(a_, d_, lm32))

        def t2_kern(a, d, pm_):
            return sl.mid_tiled_t2(a, d, pm_, *tabs)

        def t2_plain(a, d, m):
            return sl.mid_t2_plain(a, d, sl.local_tables(m, off_x, nx_loc))

        for stage, ins, kern_fn, plain_fn in (
                (1, dp, sl.mid_tiled_t1, sl.mid_t1_plain),
                (2, (a_, d_), t2_kern, t2_plain),
                (3, (pz_, dz_), sl.mid_tiled_t3, sl.mid_t3_plain)):
            stage_row(sl.TILED_STAGES[stage - 1], ins, kern_fn, plain_fn,
                      tiled_cost(stage, shape_b, BW), pm, on_path,
                      source=TILED_SOURCE,
                      derive64=max(shape_b[1:]) >= 2048)
        del a_, d_, pz_, dz_
        got = sl.pressure_mid_tiled(*dp, pm, *tabs)
        torch.cuda.synchronize()
        p32 = sl.pressure_mid_tiled_plain(*dp, lm32)
        p64 = sl.pressure_mid_tiled_plain(*to64(dp), lm64)
        err32, rel32 = rel_err(got, p32)
        _, rel64 = rel_err(got, p64)
        _, rel_p = rel_err(p32, p64)
        n_max = max(shape_b[1:])
        lim64 = (max(3e-5, 2 * rel_p) if n_max >= 2048
                 else 6e-5 if n_max >= 1024 else 3e-5)
        lim32 = max(1e-5, 2 * rel_p) if n_max >= 2048 else 1e-5
        del got, p32, p64
        ms = cuda_ms(lambda: sl.pressure_mid_tiled(*dp, pm, *tabs), 10,
                     torch)
        print(f"[pressure_mid[tiled] {n}] the three kernels in turn vs the "
              f"plain tiled mid: max|k-plain32|={err32:.3e} (rel "
              f"{rel32:.2e} <= {lim32:.2e})  rel vs plain64={rel64:.2e} (<= "
              f"{lim64:.2e}; plain32 vs plain64 rel {rel_p:.2e})  "
              f"{ms:.3f} ms", flush=True)
        check(rel32 <= lim32 and rel64 <= lim64,
              f"pressure_mid[tiled] {n}: {rel32}, {rel64} ({lim64})")
        del dp
        torch.cuda.empty_cache()
        randn_g = randn_of(gdims)
        mid_on_noise(gdims, pm, (randn_g(), randn_g(), randn_g()),
                     "white noise", True, batch=(off_x, nx_loc))
        torch.cuda.empty_cache()

    def carry_rows(shape, ns_, fields, listed=True, cut=None):
        """pipe_c[d2] on the inputs the plain pipe_a, pipe_b give from
        `fields`: u', v', w' held as pipe_c's outputs; the carry to 1e-5
        of plain float32, and to 5e-7 of the plain float64 carry of the
        kernel's own u', v', w' (the carry's function, whose float32
        evaluation and band are the kernel's own: the bound of x3d2_tpu's
        HIGHEST mode, tests/test_pallas_v3.py:114, in both modes), and to
        5e-7 of the plain float64 carry end to end (stage C's float32
        rounding of u', v', w' carried through the z operators); past the
        resident form's extents (nz > 512, the streamed form), where stage
        C's z transforms are longer (at 128 x 128 x 640 on white noise the
        kernel read 1.2e-6 end to end and 2.0e-7 on its own u', v', w': H100
        80GB HBM3, 700 W), end to end within twice plain float32's own
        distance to plain float64 (the white-noise rule), not below 5e-7,
        and u', v', w' and the carry against plain float32 within twice
        plain float32's own distance to plain float64 in each, not below
        1e-5 (at 128 x 128 x 1536 u', v', w' read 1.01e-5 from plain
        float32, 4.6e-6 from plain float64: H100 80GB HBM3, 700 W). Timed
        beside pipe_c and the z sweep (W = 16 and 32) it takes out of the
        step. listed=False: held, kept out of the kernels line. cut: x
        planes 0 .. k of the outputs and of the plain versions' inputs (as
        hold's; stage C and the carry act along y and z alone)."""
        pm_ = ns_._pipe.mats
        n = size_label(shape)
        carry = pp.build_carry_mats(ns_.ops[2], nu, device=dev)
        m32 = pm_.mats(torch.float32)
        X_, Y_ = pp.pipe_b_plain(*pp.pipe_a_plain(*fields, m32), m32)
        ins = (X_.contiguous(), Y_.contiguous()) + tuple(fields)
        del X_, Y_
        new, rhsp = pp.pipe_c_d2(*ins, pm_, carry)
        torch.cuda.synchronize()
        pins = ins
        if cut is not None:
            new = tuple(cut(t).clone() for t in new)
            rhsp = tuple(cut(t).clone() for t in rhsp)
            pins = cut_nest(ins, cut)
        p32 = flat(pp.pipe_c_d2_plain(*pins, m32, carry))
        err32, rel32 = rel_err(list(new) + list(rhsp), p32)
        _, rel32_new = rel_err(new, p32[:3])
        _, rel32_carry = rel_err(rhsp, p32[3:])
        p32_new, p32 = p32[:3], p32[3:]
        p64 = pp.pipe_c_d2_plain(*to64(pins), pm_.mats(d64), carry)
        _, rel64 = rel_err(new, p64[0])
        _, rel_e2e = rel_err(rhsp, p64[1])
        # plain float32's own distance end to end: stage C's rounding grows
        # with the z transforms' length, and the z operators carry it
        _, rel_p_e2e = rel_err(p32, p64[1])
        _, rel_p_new = rel_err(p32_new, p64[0])
        del p32, p32_new, p64
        resident = pp.carry_geometry(shape)["form"] == "resident"
        lim_e2e = 5e-7 if resident else max(5e-7, 2 * rel_p_e2e)
        # the carry against plain float32: two float32 evaluations of
        # stage C differ in u', v', w' by their rounding, which the z
        # operators carry into the partials; past the resident form's
        # extents within twice plain float32's own distance to plain
        # float64 end to end (the white-noise rule), not below 1e-5
        lim32_carry = 1e-5 if resident else max(1e-5, 2 * rel_p_e2e)
        # and u', v', w' against plain float32 likewise: their z transforms
        # are 768 long at nz = 1536, where plain float32 and the kernel
        # differ by about 1e-5
        lim32_new = 1e-5 if resident else max(1e-5, 2 * rel_p_new)
        own64 = ts.transeq_sweep_plain(*to64(new), carry.blocks, nu)
        _, rel_own = rel_err(rhsp, own64)
        del own64, new, rhsp, pins
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: pp.pipe_c_d2(*ins, pm_, carry), 10, torch)
        plain_ms = cuda_ms(lambda: pp.pipe_c_d2_plain(*ins, m32, carry), 5,
                           torch)
        alt = {}
        for terms in (2, 3):
            blocks = ts.build_sweep_blocks(ns_.ops[2], 2, device=dev,
                                           terms=terms)
            alt[terms] = cuda_ms(lambda: ts.transeq_sweep(
                *pp.pipe_c(*ins, pm_), blocks, nu), 10, torch)
        pc_ms = cuda_ms(lambda: pp.pipe_c(*ins, pm_), 10, torch)
        txt = row("pipe_c[d2]", n, CARRY_SOURCE, REPLACES["pipe_c[d2]"],
                  err32, ms, plain_ms, carry_cost(shape, pp.CARRY_W, BW))
        if not listed:
            del rows["pipe_c[d2]", n]
        report(f"pipe_c[d2] {n}", err32, rel32_new, rel64, ms, plain_ms,
               txt + f"  (u', v', w' vs plain32 and plain64, plain32 vs "
               f"plain64 rel {rel_p_new:.2e}; the carry vs "
               f"plain32 rel {rel32_carry:.2e} (<= {lim32_carry:.2e}); the "
               f"step without the "
               f"carry: pipe_c {pc_ms:.3f} ms, pipe_c + z sweep "
               f"{alt[2]:.3f} ms at W = 16, {alt[3]:.3f} ms at W = 32)",
               lim32=lim32_new)
        print(f"[pipe_c[d2] {n}] the carry vs the plain float64 carry of "
              f"the kernel's u', v', w': rel {rel_own:.2e} (<= 5e-7); vs "
              f"plain float64 end to end: rel {rel_e2e:.2e} (<= "
              f"{lim_e2e:.2e}; plain float32 end to end {rel_p_e2e:.2e})",
              flush=True)
        check(rel32_carry <= lim32_carry, f"pipe_c[d2] {n}: the carry vs "
                                          f"plain f32 {rel32_carry}")
        check(rel_own <= 5e-7, f"pipe_c[d2] {n}: the carry vs plain f64 "
                               f"{rel_own}")
        check(rel_e2e <= lim_e2e, f"pipe_c[d2] {n}: the carry vs plain f64 "
                                  f"end to end {rel_e2e}")
        if resident:
            # the streamed form at the resident form's extent: the same
            # sums in the same order, so the same bits
            a_ = flat(pp.pipe_c_d2(*ins, pm_, carry))
            b_ = flat(pp.pipe_c_d2(*ins, pm_, carry, form="streamed"))
            same = all(torch.equal(x, y) for x, y in zip(a_, b_))
            del a_, b_
            st_ms = cuda_ms(lambda: pp.pipe_c_d2(*ins, pm_, carry,
                                                 form="streamed"), 10, torch)
            print(f"[pipe_c[d2] {n}] the streamed form: "
                  f"{'bit-equal to' if same else 'differs from'} the "
                  f"resident one, {st_ms:.3f} ms against {ms:.3f}",
                  flush=True)
            check(same, f"pipe_c[d2] {n}: the streamed form's bits")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn_of(shape_):
        def randn(scale=1.0):
            return scale * torch.randn(shape_, generator=gen, device=dev)
        return randn

    # -- 3a. at 512^3: what the main path, paths B, S, R and R4 launch --
    shape = (NS,) * 3
    mesh = Mesh(shape, (2 * math.pi,) * 3, per)
    ns = NavierStokes.build(mesh, nu, device=dev)
    randn = randn_of(shape)
    acc = tuple(randn(100.0) for _ in range(3))
    olds = tuple(tuple(randn(100.0) for _ in range(2)) for _ in range(3))
    sweep_rows(shape, ns.ops, [
        ("z", 2, {}),
        ("x,acc", 0, {"acc": acc}),
        ("y,acc,ab3 steady", 1, {"acc": acc, "olds": olds,
                                 "dtc": ti.ab_row(3, DT)}),
        ("y,acc,ab3 startup", 1, {"acc": acc, "olds": olds,
                                  "dtc": ti.ab_row(1, DT)}),
        # path K's chain ends without the update (solver.transeq)
        ("y,acc", 1, {"acc": acc}),
    ], randn)
    # the RK substage updates, on the rows of the RK3 and RK4 tableaus:
    # the first substage's base is u, v, w; the later ones' the
    # step-initial fields f0, with 0, 2 (RK3's last) or 3 (RK4's last)
    # earlier stage derivatives
    rk3, rk4 = TimeIntegrator("RK3"), TimeIntegrator("RK4")
    f0 = tuple(randn() for _ in range(3))
    ks = [tuple(randn(100.0) for _ in range(3)) for _ in range(3)]

    def stage_olds(prev):
        return tuple(tuple(ks[j][c] for j in prev) for c in range(3))

    sweep_rows(shape, ns.ops, [
        ("y,acc,rk0 (RK3 substage 0)", 1,
         {"acc": acc, "olds": stage_olds([]), "dtc": rk3.rk_row(0, DT)}),
        ("y,acc,rk0,f0 (RK3 substage 1)", 1,
         {"acc": acc, "olds": stage_olds([]), "dtc": rk3.rk_row(1, DT),
          "base": f0}),
        ("y,acc,rk2,f0 (RK3 substage 2)", 1,
         {"acc": acc, "olds": stage_olds(rk3.rk_prev(2)),
          "dtc": rk3.rk_row(2, DT), "base": f0}),
        ("y,acc,rk3,f0 (RK4 substage 3)", 1,
         {"acc": acc, "olds": stage_olds(rk4.rk_prev(3)),
          "dtc": rk4.rk_row(3, DT), "base": f0}),
    ], randn)
    # the HIGHEST mode's W = 32 instances at this size: paths HI (z, x +
    # acc, y + acc + AB3), HK (y + acc) and RI, R4I (the RK rows)
    sweep_rows(shape, ns.ops, [
        ("z", 2, {}),
        ("x,acc", 0, {"acc": acc}),
        ("y,acc,ab3 steady", 1, {"acc": acc, "olds": olds,
                                 "dtc": ti.ab_row(3, DT)}),
        ("y,acc,ab3 startup", 1, {"acc": acc, "olds": olds,
                                  "dtc": ti.ab_row(1, DT)}),
        ("y,acc", 1, {"acc": acc}),
        ("y,acc,rk0 (RK3 substage 0)", 1,
         {"acc": acc, "olds": stage_olds([]), "dtc": rk3.rk_row(0, DT)}),
        ("y,acc,rk0,f0 (RK3 substage 1)", 1,
         {"acc": acc, "olds": stage_olds([]), "dtc": rk3.rk_row(1, DT),
          "base": f0}),
        ("y,acc,rk2,f0 (RK3 substage 2)", 1,
         {"acc": acc, "olds": stage_olds(rk3.rk_prev(2)),
          "dtc": rk3.rk_row(2, DT), "base": f0}),
        ("y,acc,rk3,f0 (RK4 substage 3)", 1,
         {"acc": acc, "olds": stage_olds(rk4.rk_prev(3)),
          "dtc": rk4.rk_row(3, DT), "base": f0}),
    ], randn, terms=3)
    del acc, olds, f0, ks
    # paths H and HA: the bfloat16 history, and the bfloat16 partials
    sweep_rows(shape, ns.ops, bf16_variants(randn), randn)
    torch.cuda.empty_cache()
    # a non-periodic axis of 512 points (Dirichlet x, then Neumann y): its
    # operators are not circulant, so its W = 16 sweeps take the SIMT body
    # (ts.tc_route, decided as the blocks are built); the periodic axes'
    # the tensor-core body. Held out of the kernels line: no path here
    # runs them
    for bcs, shape_np, ax in (
            (((BC.DIRICHLET,) * 2, (BC.PERIODIC,) * 2, (BC.PERIODIC,) * 2),
             (NS, 128, 256), 0),
            (((BC.PERIODIC,) * 2, (BC.NEUMANN,) * 2, (BC.PERIODIC,) * 2),
             (128, NS, 256), 1)):
        ns_np = NavierStokes.build(Mesh(shape_np, (2 * math.pi,) * 3, bcs),
                                   nu, device=dev)
        check(transport_route(ns_np, shape_np) == "sweeps",
              f"{size_label(shape_np)} {bcs}: the sweeps' route")
        blocks_np = ts.build_sweep_blocks(ns_np.ops[ax], ax, device=dev)
        check(not ts.tc_route(blocks_np), f"axis {ax} of {bcs}: the "
                                          "tensor-core route")
        randn_np = randn_of(shape_np)
        acc_np = tuple(randn_np(100.0) for _ in range(3))
        olds_np = tuple(tuple(randn_np(100.0) for _ in range(2))
                        for _ in range(3))
        tc_before = ts.tc_launch_counts()
        sweep_rows(shape_np, ns_np.ops, [
            ("x,acc" if ax == 0 else "y,acc", ax, {"acc": acc_np}),
            ("x,acc,ab3" if ax == 0 else "y,acc,ab3 steady", ax,
             {"acc": acc_np, "olds": olds_np, "dtc": ti.ab_row(3, DT)}),
        ], randn_np, listed=False)
        check(ts.tc_launch_counts() == tc_before,
              f"{size_label(shape_np)} {bcs}: a tensor-core launch")
        del ns_np, blocks_np, acc_np, olds_np
    torch.cuda.empty_cache()
    # path HIA: the HIGHEST mode with both bfloat16 streams, W = 32 (the
    # partial sweeps on bfloat16 partials, the AB update with both)
    sweep_rows(shape, ns.ops, [v for v in bf16_variants(randn)
                               if "ab3" not in v[0]
                               or ",bf16olds,bf16acc" in v[0]], randn,
               terms=3)
    torch.cuda.empty_cache()
    species_rows(shape, ns.ops, randn)
    torch.cuda.empty_cache()
    pm = ns._slab
    u, v, w = randn(), randn(), randn()
    pipe_rows(shape, (u, v, w), pm)
    carry_rows(shape, ns, (u, v, w))
    torch.cuda.empty_cache()
    # the mid without q is on no path at this size: held, not listed
    slab_rows(shape, mesh, pm, ("x_div3", "pressure_mid[q]", "x_gradsub3",
                                "div_solve", "grad"))
    # path K's gradients (x_pinv) and path M's one-field x stage
    parity_rows(shape, pm, randn, ("x_pfwd", "x_pinv", "x_pinv[sub]"))
    torch.cuda.empty_cache()
    mid_on_noise(shape, pm, (u, v, w), "white noise", True)
    # for the record, the other reason the mid's inputs are plane waves of
    # k about 12: a smooth field
    mid_on_noise(shape, pm, wave_fields(mesh, k=1), "waves of k = 1", False)
    torch.cuda.empty_cache()

    # each whole projection on the kernels against the other formulations
    # of the same projection: the transform-folded chain (plain PyTorch),
    # and slab against pipeline
    grads = ns.pressure_grads_folded(u, v, w, keep_pressure=False)[:3]
    folded = [f - g for f, g in zip((u, v, w), grads)]
    del grads
    piped = ns._pipe(u, v, w)
    slab = ns.pressure_correction(u, v, w, keep_pressure=True)[:3]
    _, rel = rel_err(piped, folded)
    _, rel_sf = rel_err(slab, folded)
    _, rel_sp = rel_err(slab, piped)
    print(f"[pipe] projection on the kernels vs the folded chain: rel "
          f"{rel:.2e} (<= 1e-5)", flush=True)
    print(f"[slab] projection on the kernels vs the folded chain: rel "
          f"{rel_sf:.2e} (<= 1e-5); vs the pipeline: rel {rel_sp:.2e} "
          f"(<= 1e-5)", flush=True)
    check(rel <= 1e-5, f"pipeline vs folded projection {rel}")
    check(rel_sf <= 1e-5, f"slab vs folded projection {rel_sf}")
    check(rel_sp <= 1e-5, f"slab vs pipeline projection {rel_sp}")
    del u, v, w, ns, folded, piped, slab
    pm._dev.pop(d64, None)
    del pm
    torch.cuda.empty_cache()

    # -- 3b. at 256^3: what path A launches, and what the same grid
    # launches with X3D2_XDIV_FUSED=0 (another grid and tile count than at
    # 512^3 for every kernel) --
    shape_a = (NA,) * 3
    mesh_a = Mesh(shape_a, (2 * math.pi,) * 3, per)
    ns_a = NavierStokes.build(mesh_a, nu, device=dev)
    randn_a = randn_of(shape_a)

    def xdiv_variants(ns_, n_x, acc, olds, terms=2):
        f64m = ns_._fp_mats64()
        xm = ts.build_xdiv_mats(f64m["sx"], f64m["ix"], n_x, device=dev,
                                bs=ts.geometry(terms)[0])
        return [
            ("z", 2, {}),
            ("y,acc", 1, {"acc": acc}),
            ("x,acc,ab3,xdiv steady", 0, {"acc": acc, "olds": olds,
                                          "dtc": ti.ab_row(3, DT),
                                          "xdiv": xm}),
            ("x,acc,ab3,xdiv startup", 0, {"acc": acc, "olds": olds,
                                           "dtc": ti.ab_row(1, DT),
                                           "xdiv": xm})]

    acc = tuple(randn_a(100.0) for _ in range(3))
    olds = tuple(tuple(randn_a(100.0) for _ in range(2)) for _ in range(3))
    sweep_rows(shape_a, ns_a.ops, xdiv_variants(ns_a, NA, acc, olds) + [
        ("x,acc", 0, {"acc": acc}),
        ("y,acc,ab3 steady", 1, {"acc": acc, "olds": olds,
                                 "dtc": ti.ab_row(3, DT)}),
        ("y,acc,ab3 startup", 1, {"acc": acc, "olds": olds,
                                  "dtc": ti.ab_row(1, DT)}),
    ], randn_a)
    # path AI: the HIGHEST mode's xdiv chain, W = 32
    sweep_rows(shape_a, ns_a.ops, xdiv_variants(ns_a, NA, acc, olds, 3),
               randn_a, terms=3)
    del acc, olds
    pm_a = ns_a._slab
    noise_a = (randn_a(), randn_a(), randn_a())
    pipe_rows(shape_a, noise_a, pm_a)
    # x_div3 and the mid with q are on no path at this size
    slab_rows(shape_a, mesh_a, pm_a, ("pressure_mid", "x_gradsub3"))
    mid_on_noise(shape_a, pm_a, noise_a, "white noise", True)
    del noise_a, ns_a, pm_a
    torch.cuda.empty_cache()

    # -- 3c. at (128, 128, 256), the example grid: what path S-ex launches --
    mesh_e = Mesh(SMALL, (2 * math.pi,) * 3, per)
    ns_e = NavierStokes.build(mesh_e, nu, device=dev)
    randn_e = randn_of(SMALL)
    acc = tuple(randn_e(100.0) for _ in range(3))
    olds = tuple(tuple(randn_e(100.0) for _ in range(2)) for _ in range(3))
    sweep_rows(SMALL, ns_e.ops, xdiv_variants(ns_e, SMALL[0], acc, olds),
               randn_e)
    del acc, olds
    # phase 8's chains at this grid: the xdiv chain with a bfloat16
    # history, and with bfloat16 partials too; the z, x, y chain with a
    # bfloat16 history (X3D2_XDIV_FUSED=0)
    f64e = ns_e._fp_mats64()
    xm_e = ts.build_xdiv_mats(f64e["sx"], f64e["ix"], SMALL[0], device=dev)
    olds16 = tuple(tuple(randn_e(100.0).to(torch.bfloat16) for _ in range(2))
                   for _ in range(3))
    acc_e = tuple(randn_e(100.0) for _ in range(3))
    olds_e = tuple(tuple(randn_e(100.0) for _ in range(2)) for _ in range(3))
    sweep_rows(SMALL, ns_e.ops, bf16_variants(randn_e, xm_e) + [
        ("y,acc,ab3,bf16olds steady", 1, {
            "acc": acc_e, "olds": olds16,
            "dtc": ti.ab_row(3, DT, feedback=True)}),
        # the z, x, y chain of phase 8's compensated, X3D2_MERGED_X=0 and
        # xdiv-off chains
        ("x,acc", 0, {"acc": acc_e}),
        ("y,acc,ab3 steady", 1, {"acc": acc_e, "olds": olds_e,
                                 "dtc": ti.ab_row(3, DT)})], randn_e)
    # phase 8's HIGHEST chains at this grid, W = 32: the xdiv chain, the
    # compensated one (z, x + acc, y + acc), RK3 with two scalars (the
    # same, and the species sweeps) and the carry's (x + acc, y + acc +
    # AB3)
    sweep_rows(SMALL, ns_e.ops, xdiv_variants(ns_e, SMALL[0], acc_e, olds_e,
                                              3)
               + [("x,acc", 0, {"acc": acc_e}),
                  ("y,acc,ab3 steady", 1, {"acc": acc_e, "olds": olds_e,
                                           "dtc": ti.ab_row(3, DT)}),
                  ("y,acc,ab3 startup", 1, {"acc": acc_e, "olds": olds_e,
                                            "dtc": ti.ab_row(1, DT)})],
               randn_e, terms=3)
    species_rows(SMALL, ns_e.ops, randn_e, terms=3)
    # phase 8's HIGHEST chains with a bfloat16 history, and with bfloat16
    # partials: the xdiv chain at W = 32 with either stream
    xm_e32 = ts.build_xdiv_mats(f64e["sx"], f64e["ix"], SMALL[0], device=dev,
                                bs=ts.geometry(3)[0])
    sweep_rows(SMALL, ns_e.ops, [v for v in bf16_variants(randn_e, xm_e32)
                                 if ",bf16olds,bf16acc" not in v[0]],
               randn_e, terms=3)
    del olds16, acc_e, olds_e, xm_e32
    species_rows(SMALL, ns_e.ops, randn_e)
    pm_e = ns_e._slab
    # phase 8's chains also launch x_div3, the mid with q and the pipeline
    slab_rows(SMALL, mesh_e, pm_e, ("x_div3", "pressure_mid[q]",
                                    "pressure_mid", "x_gradsub3",
                                    "div_solve", "grad"))
    fields_e = (randn_e(), randn_e(), randn_e())
    pipe_rows(SMALL, fields_e, pm_e)
    carry_rows(SMALL, ns_e, fields_e)
    del fields_e
    # phase 8's compensated chains (x_pinv) and X3D2_MERGED_X=0 chain
    parity_rows(SMALL, pm_e, randn_e, ("x_pfwd", "x_pinv", "x_pinv[sub]"))
    mid_on_noise(SMALL, pm_e, (randn_e(), randn_e(), randn_e()),
                 "white noise", True)
    del ns_e, pm_e
    torch.cuda.empty_cache()

    # -- 3d. at 128^3: what path T128 launches, the dense transport sweeps
    # (x3d2_tpu's v1 kernel; its bound there is its HIGHEST mode's) --
    shape_t = (NT,) * 3
    ns_t = NavierStokes.build(Mesh(shape_t, (2 * math.pi,) * 3, per), nu,
                              device=dev)
    check(ns_t._v1 is not None and ns_t._sweeps is None,
          "128^3 must take the dense sweeps")
    randn_t = randn_of(shape_t)
    comps_t = (randn_t(), randn_t(), randn_t())
    for axis in (2, 0, 1):
        mats_t = ns_t._v1.mats[axis]
        name = td.variant_name(axis)
        hold(name, size_label(shape_t),
             lambda u, v, w, m=mats_t: td.transeq_dense(u, v, w, m),
             lambda u, v, w, m=mats_t: td.transeq_dense_plain(u, v, w, m),
             comps_t, name, REPLACES["transeq_dense"],
             dense_sweep_cost(shape_t, axis), source=DENSE_SOURCE,
             lim64=5e-7)
    # path T128's projection is the pipeline, at this size too
    pipe_rows(shape_t, comps_t, ns_t._slab)
    del ns_t, comps_t
    torch.cuda.empty_cache()
    # the pipeline at a z half not a multiple of 16 (nz = 144: halves of
    # 72, the tensor-core kernel's last k chunk part-filled), held on no
    # path (x3d2_tpu's slab gate takes z in multiples of 128)
    ns_k = NavierStokes.build(Mesh(Z_HALF, (2 * math.pi,) * 3, per), nu,
                              device=dev)
    randn_k = randn_of(Z_HALF)
    pipe_rows(Z_HALF, (randn_k(), randn_k(), randn_k()),
              build_projection_mats(ns_k), on_path=False)
    del ns_k
    torch.cuda.empty_cache()

    # -- 3e. at 513 x 256 x 128: what path C launches, the dense x stage of
    # the slab and its mid over the 512 x planes with the Nyquist mask --
    cfg_c = config.Config.from_file(CYL_EXAMPLE)
    check(tuple(cfg_c.domain.dims_global) == (257, 128, 32)
          and cfg_c.solver.ibm_on and cfg_c.solver.time_intg == "AB3",
          f"{CYL_EXAMPLE}: unexpected configuration {cfg_c}")
    cfg_c.domain.dims_global = CYL
    mesh_c = Mesh.from_config(cfg_c.domain)
    ns_c = NavierStokes.build(mesh_c, 1.0 / cfg_c.solver.Re, device=dev)
    pm_c = ns_c._slab
    check(pm_c is not None and pm_c.x_perm is None and ns_c._pipe is None
          and "myz" in pm_c.m64 and ns_c._transport == "dense",
          "the cylinder grid must take the slab with the dense x stage and "
          "the Nyquist mask, and the dense transport")
    lab_c = size_label(CYL)
    ncell = tuple(pm_c.shape)

    def x_apply_hold(op, pm, f, s, n, listed=True):
        """The dense x apply of pm's operator `op` (with the correction
        when s is given; the split-TF32 kernel of MANUAL_SOURCE) against its
        plain version, beside one torch.matmul or torch.addmm on the same
        operands; two launches must give the same bits."""
        M = pm.mats(torch.float32)[op]
        n_out, n_in = M.shape
        name = "x_apply" if s is None else "x_apply[sub]"

        def kern(f, s=None):
            return (sl.x_apply(op, f, pm, s),)

        def plain(f, s=None):
            return (sl.x_apply_plain(pm.mats(f.dtype)[op], f, s),)

        def library(f, s=None):
            f2 = f.reshape(n_in, -1)
            r = (torch.matmul(M, f2) if s is None else
                 torch.addmm(s.reshape(n_out, -1), M, f2, alpha=-1.0))
            return r.reshape((n_out,) + tuple(f.shape[1:]))

        hold(f"{name}[{op}]", n, kern, plain,
             (f,) if s is None else (f, s), name, REPLACES[name],
             x_apply_cost(n_out, n_in, f.shape[1], f.shape[2], s is not None),
             again=True, source=MANUAL_SOURCE, library=library,
             listed=listed, tc=True)

    randn_c, randn_cc = randn_of(CYL), randn_of(ncell)
    for op in ("sx", "ix"):
        x_apply_hold(op, pm_c, randn_c(), None, lab_c)
    # the gradients without the correction (pressure_grads: the
    # compensated cylinder), (nvx, ncx) operators on the same instance
    for op in ("gxs", "gxi"):
        x_apply_hold(op, pm_c, randn_cc(), None, lab_c)
    for op in ("gxs", "gxi"):
        x_apply_hold(op, pm_c, randn_cc(), randn_c(), lab_c)
    # a remainder in K and in the output rows, at 17 -> 16 and 16 -> 17
    # points, and n_in, n_out and ny nz all off the kernel's tiles, 201 ->
    # 199 points on 36 x 20 columns (random operators; held, not listed)
    rng_r = torch.Generator(device="cpu").manual_seed(1)
    pm_r = ProjectionMats(
        shape=(16, 128, 128), device=dev, x_perm=None, q_perm=None,
        z_perm=None,
        m64={"m17": torch.randn(16, 17, generator=rng_r,
                                dtype=d64).numpy(),
             "m16": torch.randn(17, 16, generator=rng_r,
                                dtype=d64).numpy(),
             "m201": torch.randn(199, 201, generator=rng_r,
                                 dtype=d64).numpy()})
    for op, n_in, n_out, yz in (("m17", 17, 16, (128, 128)),
                                ("m16", 16, 17, (128, 128)),
                                ("m201", 201, 199, (36, 20))):
        f_r = randn_of((n_in,) + yz)()
        s_r = randn_of((n_out,) + yz)()
        lab_r = size_label((n_in,) + yz)
        x_apply_hold(op, pm_r, f_r, None, lab_r, listed=False)
        x_apply_hold(op, pm_r, f_r, s_r, lab_r, listed=False)
    del pm_r, f_r, s_r
    # the mid over the 512 x planes (keep_pressure=False: without q)
    m32_c = pm_c.mats(torch.float32)
    dp_c = tuple(t.contiguous()
                 for t in div_plain(wave_fields(mesh_c), m32_c, pm_c))
    stage_row("pressure_mid", dp_c, mid_nq, mid_nq_plain,
              slab_cost("pressure_mid", ncell, BW), pm_c, n=lab_c)
    del dp_c
    torch.cuda.empty_cache()
    mid_on_noise(CYL, pm_c, (randn_c(), randn_c(), randn_c()),
                 "white noise", True)
    torch.cuda.empty_cache()
    # the mask in the solve epilogue: on tables made regular everywhere
    # (the compact interpolations' own zero at the Nyquist line otherwise
    # leaves the zero-wave guard to zero it), q on the line is exactly 0,
    # the rest is the plain version's
    mreg = dict(m32_c)
    mreg["tab_a"] = torch.ones_like(mreg["tab_a"])
    mreg["tab_b"] = torch.full_like(mreg["tab_b"], 2.0)
    z_c = randn_cc()
    q_c = torch.empty_like(z_c)
    oa.apply("solve mask check", oa.PFWD, 1, [([mreg["ty"]], [z_c], q_c,
                                               None)],
             epi=oa.SOLVE_PLANE, tabs=(mreg["tab_a"], mreg["tab_b"],
                                       mreg["k2x"], mreg["tx2"],
                                       mreg["myz"], mreg["mx"]))
    F_c = pfwd(mreg["ty"], z_c, 1)
    q_plain = F_c * solve_factor(mreg, ncell)
    unmasked = F_c * solve_factor({k: t for k, t in mreg.items()
                                   if k not in ("myz", "mx")}, ncell)
    line = mreg["myz"].reshape(ncell[1:]) > 0
    _, rel_q = rel_err([q_c], [q_plain])
    on_line = float(q_c[:, line].abs().max())
    energy = float(unmasked[:, line].abs().min())
    print(f"[solve mask {lab_c}] q on the Nyquist line: max |q| {on_line:.1e}"
          f" (== 0; unmasked min |q| {energy:.2e}), elsewhere vs plain f32 "
          f"rel {rel_q:.2e} (<= 1e-5)", flush=True)
    check(on_line == 0.0 and energy > 0 and int(line.sum()) == 1
          and rel_q <= 1e-5, "the solve epilogue's Nyquist mask")
    del ns_c, pm_c, m32_c, mreg, z_c, q_c, F_c, q_plain, unmasked
    torch.cuda.empty_cache()
    # at (65, 128, 128), phase 8's compensated cylinder: the dense x applies
    # without the correction and the mid with q
    cfg_c.domain.dims_global = CYL_SMALL
    ns_k = NavierStokes.build(Mesh.from_config(cfg_c.domain),
                              1.0 / cfg_c.solver.Re, device=dev)
    pm_k, lab_k = ns_k._slab, size_label(CYL_SMALL)
    randn_k, randn_kc = randn_of(CYL_SMALL), randn_of(tuple(pm_k.shape))
    for op in ("sx", "ix"):
        x_apply_hold(op, pm_k, randn_k(), None, lab_k)
    for op in ("gxs", "gxi"):
        x_apply_hold(op, pm_k, randn_kc(), None, lab_k)
    # with the correction: phase 8's cylinder with X3D2_MID_SPLIT=1
    for op in ("gxs", "gxi"):
        x_apply_hold(op, pm_k, randn_kc(), randn_k(), lab_k)
    # the mid with q (compensated) and its halves (X3D2_MID_SPLIT=1)
    slab_rows(CYL_SMALL, Mesh.from_config(cfg_c.domain), pm_k,
              ("pressure_mid[q]", "div_solve", "grad"), n=lab_k)
    del ns_k, pm_k
    torch.cuda.empty_cache()

    # -- 3f. X3D2_BFLY=0: the slab's dense forms, at 512^3 (path BD) and at
    # 128 x 128 x 256 (phase 8's dense chains): the dense x applies of a
    # periodic x, the dense mid and its halves --
    for shape_d, on_path in (((NS,) * 3, ("pressure_mid[q,dense]",)),
                             (SMALL, ("pressure_mid[q,dense]",
                                      "pressure_mid[dense]",
                                      "div_solve[dense]", "grad[dense]"))):
        mesh_d = Mesh(shape_d, (2 * math.pi,) * 3, per)
        with env_set({"X3D2_BFLY": "0"}):
            ns_d = NavierStokes.build(mesh_d, nu, device=dev)
        pm_d, lab_d = ns_d._slab, size_label(shape_d)
        check(pm_d.dense and pm_d.x_perm is None and ns_d._pipe is not None
              and not ns_d._pipe.mats.dense,
              "X3D2_BFLY=0: the slab's dense forms beside the pipeline's "
              "parity splits")
        randn_d = randn_of(shape_d)
        for op in ("sx", "ix", "gxs", "gxi"):
            x_apply_hold(op, pm_d, randn_d(), None, lab_d)
        for op in ("gxs", "gxi"):
            x_apply_hold(op, pm_d, randn_d(), randn_d(), lab_d)
        torch.cuda.empty_cache()
        slab_rows(shape_d, mesh_d, pm_d, on_path)
        torch.cuda.empty_cache()
        mid_on_noise(shape_d, pm_d, (randn_d(), randn_d(), randn_d()),
                     "white noise", True)
        del ns_d, pm_d, randn_d
        torch.cuda.empty_cache()

    stamp("phase 3h")
    # -- 3h. the sharded step's kernels (phase 9) at the ranks' blocks: the
    # sweeps (the halo form on a sharded axis, its extended operands sliced
    # from the global field as the neighbour exchange gives them, at the
    # last rank of the mesh: a nonzero block offset), the species sweeps,
    # the one-field parity x applies and the mid over the rank's x batch
    # (its table slices; plane waves, as slab_rows) --
    def halo_args(glob, axis, mesh_s, coords, w):
        """The rank's block of each global field, and along a sharded axis
        its halo-extended operand (None along an unsharded one)."""
        blk, ext = [], []
        for f in glob:
            sl_ = [slice(None)] * 3
            for a, (p, c) in zip((1, 2), zip(mesh_s, coords)):
                n = f.shape[a] // p
                sl_[a] = slice(c * n, (c + 1) * n)
            blk.append(f[tuple(sl_)].contiguous())
            p = mesh_s[axis - 1] if axis else 1
            if p > 1:
                n, N = blk[-1].shape[axis], f.shape[axis]
                c = coords[axis - 1]
                idx = torch.arange(c * n - w, (c + 1) * n + w,
                                   device=dev) % N
                sl_[axis] = idx
                ext.append(f[tuple(sl_)].contiguous())
        return blk, (tuple(ext) if ext else None)

    for gdims, mesh_s, modes, scalars in (
            ((NS,) * 3, (2, 2), (2,), False),
            (SHARD_SMALL, (2, 2), (2, 3), True),
            (SHARD_Z, (1, 4), (2,), False),
            (SHARD_TILED, (2, 2), (2,), False),
            (SHARD_TY, (2, 2), (2,), False),
            (SHARD_TZ, (2, 2), (2,), False)):
        ns_h = NavierStokes.build(Mesh(gdims, (2 * math.pi,) * 3, per), nu,
                                  device=dev)
        local = (gdims[0], gdims[1] // mesh_s[0], gdims[2] // mesh_s[1])
        lab = size_label(local)
        coords = (mesh_s[0] - 1, mesh_s[1] - 1)
        randn_g, randn_l = randn_of(gdims), randn_of(local)
        glob = (randn_g(), randn_g(), randn_g())
        acc_l = tuple(randn_l(100.0) for _ in range(3))
        for terms in modes:
            bs, w = ts.geometry(terms)
            w32 = w != ts.W
            for axis, a in ((2, None), (0, acc_l), (1, acc_l)):
                blocks = ts.build_sweep_blocks(ns_h.ops[axis], axis,
                                               device=dev, terms=terms)
                (u, v, w_), ext = halo_args(glob, axis, mesh_s, coords, w)
                off = coords[axis - 1] * (local[axis] // bs) if ext else 0
                frac = (local[axis] + 2 * w) / local[axis] if ext else 1.0

                def kern(u, v, w_, a, e, blocks=blocks, off=off):
                    return ts.transeq_sweep(u, v, w_, blocks, nu, acc=a,
                                            exts=e, off=off)

                def plain(u, v, w_, a, e, blocks=blocks, off=off):
                    return ts.transeq_sweep_plain(u, v, w_, blocks, nu,
                                                  acc=a, exts=e, off=off)

                name = ts.variant_name(axis, a is not None, 0, w=w,
                                       halo=ext is not None)
                # the unsharded axis' W = 16 sweep: the tensor-core body
                tc = ts.tc_route(blocks, halo=ext is not None)
                hold(f"sweep {name[14:-1]} {gdims} on {mesh_s}", lab, kern,
                     plain, (u, v, w_, a, ext), name,
                     REPLACES["halo" if ext else axis],
                     sweep_cost(local, a is not None, 0, w, ext=frac),
                     source=(SWEEP32_SOURCE if w32 else SWEEP_TC_SOURCE if tc
                             else SWEEP_SOURCE),
                     lim64=5e-7 if w32 else 3e-5, tc=tc)
                if not scalars:
                    continue
                phis = (randn_g(), randn_g())
                (conv, p1, p2), sext = halo_args(
                    (glob[axis],) + phis, axis, mesh_s, coords, w)
                sa = acc_l[:2] if a is not None else None

                def skern(phis, conv, a, e, blocks=blocks, off=off):
                    return spm.species_sweep(phis, conv, blocks, nus, acc=a,
                                             exts=e, off=off)

                def splain(phis, conv, a, e, blocks=blocks, off=off):
                    return spm.species_sweep_plain(phis, conv, blocks, nus,
                                                   acc=a, exts=e, off=off)

                sname = spm.variant_name(axis, a is not None, w,
                                         halo=sext is not None)
                hold(f"{sname} {gdims} on {mesh_s}", lab, skern, splain,
                     ((p1, p2), conv, sa, sext), sname,
                     REPLACES["species_halo" if sext else "species"],
                     species_cost(local, len(nus), a is not None, w,
                                  ext=frac),
                     source=SWEEP32_SOURCE if w32 else SWEEP_SOURCE,
                     lim64=5e-7 if w32 else 3e-5)
                del phis, conv, p1, p2, sext
            torch.cuda.empty_cache()
        del glob, acc_l
        pm_h = ns_h._slab
        # the x stage of the repencilled projection, one field a launch
        parity_rows(local, pm_h, randn_l, ("x_pfwd", "x_pinv[sub]"))
        # the mid over the rank's x batch: the x-transformed plane waves'
        # planes of that batch, the solve tables sliced there
        nx_loc = gdims[0] // (mesh_s[0] * mesh_s[1])
        off_x = (coords[0] * mesh_s[1] + coords[1]) * nx_loc
        if not sl.tpu_slab_vmem_ok(ns_h, 2):
            # x3d2_tpu's tiled mid at these planes (phase 9's tiled run),
            # on the operator set the repencilled projection builds; and
            # at a small size, held but not listed
            check(sl.tiled_mid_supported(ns_h, 2),
                  f"{gdims}: the tiled mid must be supported")
            tiled_rows(gdims, build_projection_mats(ns_h),
                       off_x, nx_loc, True)
            del ns_h, pm_h
            torch.cuda.empty_cache()
            if gdims != SHARD_TILED:
                continue
            ns_s = NavierStokes.build(Mesh(TILED_SMALL, (2 * math.pi,) * 3,
                                           per), nu, device=dev)
            n_s = TILED_SMALL[0] // 4
            tiled_rows(TILED_SMALL, build_projection_mats(
                ns_s), 3 * n_s, n_s, False)
            del ns_s
            torch.cuda.empty_cache()
            continue
        m32 = pm_h.mats(torch.float32)
        dp = tuple(t[off_x:off_x + nx_loc].contiguous() for t in div_plain(
            wave_fields(Mesh(gdims, (2 * math.pi,) * 3, per)), m32, pm_h))

        def mid_loc(du, dv, dw, pm, off_x=off_x, n=nx_loc):
            m_ = pm.mats(torch.float32)
            return sl.pressure_mid_local(du, dv, dw, pm,
                                         m_["k2x"][off_x:off_x + n],
                                         m_["tx2"][off_x:off_x + n])

        def mid_loc_plain(du, dv, dw, m, off_x=off_x, n=nx_loc,
                          forms=Forms()):
            return sl.pressure_mid_plain(
                du, dv, dw, sl.local_tables(m, off_x, n), True, forms)

        stage_row("pressure_mid[q,local]", dp, mid_loc, mid_loc_plain,
                  slab_cost("pressure_mid[q]", dp[0].shape, BW), pm_h)
        del ns_h, pm_h, m32, dp
        torch.cuda.empty_cache()
        if gdims != SHARD_SMALL:
            continue
        # X3D2_BFLY=0 (phase 9's dense run): the dense x applies of the
        # rank's block, the dense mid over its x batch
        mesh_h = Mesh(gdims, (2 * math.pi,) * 3, per)
        with env_set({"X3D2_BFLY": "0"}):
            pm_d = NavierStokes.build(mesh_h, nu, device=dev)._slab
        check(pm_d.dense and pm_d.x_perm is None,
              "X3D2_BFLY=0: the dense forms at the sharded grid")
        for op in ("sx", "ix"):
            x_apply_hold(op, pm_d, randn_l(), None, lab)
        for op in ("gxs", "gxi"):
            x_apply_hold(op, pm_d, randn_l(), randn_l(), lab)
        dd = tuple(t[off_x:off_x + nx_loc].contiguous() for t in div_plain(
            wave_fields(mesh_h), pm_d.mats(torch.float32), pm_d))
        stage_row("pressure_mid[q,dense,local]", dd, mid_loc,
                  partial(mid_loc_plain, forms=pm_d.forms),
                  slab_cost("pressure_mid[q]", dd[0].shape, BW, "dense",
                            "dense"), pm_d)
        del pm_d, dd
        torch.cuda.empty_cache()

    stamp("phase 3i")
    # -- 3i. the tails: the template's general instance at the extents
    # x3d2_tpu's gates admit past its 128-point tiles, at the grids of path
    # PX (the sweeps and the pipeline; its x applies on parity halves of
    # 160), paths PY and PYB (the pipeline, and the slab with q; their y
    # applies on 3 banded blocks of 64 and halves of 96) and path YD (the
    # slab without q on the folded y: the dense y at 200) --
    for dims, on_path in ((PX, ()), (PY, ("x_div3", "pressure_mid[q]",
                                          "x_gradsub3")),
                          (YD, ("x_div3", "pressure_mid[folded_y]",
                                "x_gradsub3"))):
        mesh_x = Mesh(dims, (2 * math.pi,) * 3, per)
        ns_x = NavierStokes.build(mesh_x, nu, device=dev)
        pm_x = ns_x._slab
        check(ns_x._projection_gap is None, f"{dims}: a projection gap")
        randn_x = randn_of(dims)
        if dims == PX:
            acc = tuple(randn_x(100.0) for _ in range(3))
            olds = tuple(tuple(randn_x(100.0) for _ in range(2))
                         for _ in range(3))
            sweep_rows(dims, ns_x.ops, [
                ("z", 2, {}),
                ("x,acc", 0, {"acc": acc}),
                ("y,acc,ab3 steady", 1, {"acc": acc, "olds": olds,
                                         "dtc": ti.ab_row(3, DT)}),
                ("y,acc,ab3 startup", 1, {"acc": acc, "olds": olds,
                                          "dtc": ti.ab_row(1, DT)})],
                randn_x)
            del acc, olds
            torch.cuda.empty_cache()
        fields = (randn_x(), randn_x(), randn_x())
        if ns_x._pipe is not None:
            pipe_rows(dims, fields, pm_x)
        if dims == PX:
            # the carry at nz = 384 (X3D2_D2C=1 on this grid, as x3d2_tpu
            # takes it with the sweeps) and the one-field parity x applies
            # at x = 320: held, on no path here
            carry_rows(dims, ns_x, fields, listed=False)
            parity_rows(dims, pm_x, randn_x, ("x_pfwd", "x_pinv[sub]"),
                        listed=False)
        slab_rows(dims, mesh_x, pm_x, on_path)
        if dims == PY:
            # the local mid over a rank's batch of 32 x planes at the y tail
            # (the sharded projection's, as at 384 x 192 x 384 on (2, 2) or
            # (1, 4)): held, on no path here
            off_l, n_l = 2 * 32, 32
            m32 = pm_x.mats(torch.float32)
            dl = tuple(t[off_l:off_l + n_l].contiguous() for t in div_plain(
                wave_fields(mesh_x), m32, pm_x))

            def mid_l(du, dv, dw, pm, off=off_l, n=n_l):
                m_ = pm.mats(torch.float32)
                return sl.pressure_mid_local(du, dv, dw, pm,
                                             m_["k2x"][off:off + n],
                                             m_["tx2"][off:off + n])

            def mid_l_plain(du, dv, dw, m, off=off_l, n=n_l):
                return sl.pressure_mid_plain(
                    du, dv, dw, sl.local_tables(m, off, n), True)

            stage_row("pressure_mid[q,local]", dl, mid_l, mid_l_plain,
                      slab_cost("pressure_mid[q]", dl[0].shape, BW), pm_x,
                      on_path=False)
            del dl, m32
        del ns_x, pm_x, fields
        torch.cuda.empty_cache()

    stamp("phase 3k")
    # -- 3k. the carry's streamed form (nz past 512) and the tiled mid's
    # long form held on grids no path runs. At D640 (phase 8's carried
    # chain) the boot z sweep, x + acc, y + acc + AB3 (both rows), pipe_a,
    # pipe_b and pipe_c[d2]; at DZ (paths DZ and MZ) the same and pipe_c,
    # the sweeps and the carry held on 64 x planes or y rows (their plain
    # float64 versions on the whole grid would not fit beside the kernels':
    # each acts within them); the carry at CARRY_HELD, on no path --
    for dims in (D640, DZ):
        ns_c = NavierStokes.build(Mesh(dims, (2 * math.pi,) * 3, per), nu,
                                  device=dev)
        check(ns_c._pipe is not None
              and pp.carry_geometry(dims)["form"] == "streamed",
              f"{dims}: the pipeline and the carry's streamed form")
        randn_c = randn_of(dims)
        acc = tuple(randn_c(100.0) for _ in range(3))
        olds = tuple(tuple(randn_c(100.0) for _ in range(2))
                     for _ in range(3))
        # at DZ each sweep held on 64 x planes (the z and y sweeps) or 64 y
        # rows (the x sweep): the planes or rows it acts within
        cut = (lambda t: t[:64]) if dims == DZ else None
        cut_y = (lambda t: t[:, :64]) if dims == DZ else None
        sweep_rows(dims, ns_c.ops, [
            ("z", 2, {"cut": cut}),
            ("x,acc", 0, {"acc": acc, "cut": cut_y}),
            ("y,acc,ab3 steady", 1, {"acc": acc, "olds": olds,
                                     "dtc": ti.ab_row(3, DT), "cut": cut}),
            ("y,acc,ab3 startup", 1, {"acc": acc, "olds": olds,
                                      "dtc": ti.ab_row(1, DT), "cut": cut})],
            randn_c)
        del acc, olds
        torch.cuda.empty_cache()
        fields = (randn_c(), randn_c(), randn_c())
        pm_c = ns_c._pipe.mats
        if dims == DZ:
            pipe_rows(dims, fields, pm_c)
        else:
            m32 = pm_c.mats(torch.float32)
            a_, e_ = pp.pipe_a_plain(*fields, m32)
            for name, ins, kern_fn, plain_fn in [
                    ("pipe_a", fields, pp.pipe_a, pp.pipe_a_plain),
                    ("pipe_b", (a_, e_), pp.pipe_b, pp.pipe_b_plain)]:
                stage_row(name, ins, kern_fn, plain_fn,
                          pipe_cost(name, dims, BW), pm_c)
            del a_, e_, m32
        carry_rows(dims, ns_c, fields, cut=cut)
        del ns_c, pm_c, fields
        torch.cuda.empty_cache()
    for dims in CARRY_HELD:
        ns_c = NavierStokes.build(Mesh(dims, (2 * math.pi,) * 3, per), nu,
                                  device=dev)
        randn_c = randn_of(dims)
        carry_rows(dims, ns_c, (randn_c(), randn_c(), randn_c()),
                   listed=False)
        del ns_c
        torch.cuda.empty_cache()
    for gdims in TILED_HELD:
        ns_t = NavierStokes.build(Mesh(gdims, (2 * math.pi,) * 3, per), nu,
                                  device=dev)
        check(not sl.tpu_slab_vmem_ok(ns_t, 2)
              and sl.tiled_mid_supported(ns_t, 2),
              f"{gdims}: x3d2_tpu's tiled mid on a (2, 2) mesh")
        n_t = gdims[0] // 4
        tiled_rows(gdims, build_projection_mats(ns_t), 3 * n_t, n_t, False)
        del ns_t
        torch.cuda.empty_cache()

    stamp("phase 3j")
    # -- 3j. the manual entry of the x-apply kernel (ops/x_apply_manual.py,
    # on no solver path; tools/prof_manual.py, phase 7c, is its path) on
    # the operators of tools/prof_manual.py at 512^3 and at x = 320: each
    # form held at S = 4 beside one torch.matmul / torch.addmm of the dense
    # operator, then at S = 2, 3, 6 (at 512^3) bit-equal to S = 4 and
    # timed --
    for dims, listed in (((NS,) * 3, True), (PX, False)):
        n_m = dims[0]
        Mf, Mi = pmt.operators(n_m)
        randn_m = randn_of(dims)
        for _, parity, sub in pmt.FORMS:
            M = Mi if parity == "inv" else Mf
            fns = {S: xm.make_x_apply_manual(M, sub=sub, parity=parity,
                                             slots=S, device=dev)
                   for S in pmt.SLOTS}
            Md = torch.as_tensor(M, dtype=torch.float32, device=dev)

            def kern(f, s_, fn=fns[4]):
                return (fn(f, s_),)

            def plain(f, s_, fn=fns[4], parity=parity):
                return (xm.x_apply_manual_plain(fn.op(f.dtype), f, s_,
                                                parity),)

            def library(f, s_, Md=Md, n_m=n_m):
                f2 = f.reshape(n_m, -1)
                r = (torch.matmul(Md, f2) if s_ is None else
                     torch.addmm(s_.reshape(n_m, -1), Md, f2, alpha=-1.0))
                return r.reshape(f.shape)

            name = xm.stage_name(parity, sub)
            cost = (x_apply_cost(n_m, n_m, dims[1], dims[2], sub)
                    if parity is None else x_parity_cost(dims, sub))
            args = (randn_m(), randn_m() if sub else None)
            hold(name, size_label(dims), kern, plain, args, name,
                 REPLACES["x_apply_manual"], cost, again=True,
                 source=MANUAL_SOURCE, library=library, listed=listed,
                 tc=True)
            if listed:
                ref = fns[4](*args)
                lib_ms = cuda_ms(lambda: library(*args), 10, torch)
                times = {}
                b_tc = bound(*cost, tc=True)[0]
                for S in pmt.SLOTS:
                    check(torch.equal(fns[S](*args), ref),
                          f"{name}: S = {S} differs from S = 4")
                    times[S] = cuda_ms(lambda S=S: fns[S](*args), 10, torch)
                    check(b_tc <= times[S], f"{name} S = {S}: beats its "
                                            "bound")
                print(f"[{name} {size_label(dims)}, S = 2, 3, 4, 6] bit-"
                      "equal; ms " + ", ".join(
                          f"S={S} {t:.3f} ({b_tc / t:.0%} of the split-TF32 "
                          "bound)" for S, t in times.items())
                      + f"; library {lib_ms:.3f}", flush=True)
                del ref
            del fns, Md, args
        torch.cuda.empty_cache()

    # ---- 4-7. the paths ------------------------------------------------------
    stamp("phases 4-7 (the paths)")
    params = SolverParams(Re=1600.0, time_intg="AB3", dt=DT)
    params_s = SolverParams(Re=1600.0, time_intg="AB3", dt=DT, n_species=2,
                            pr_species=PR)
    sweeps_zxy = [ts.variant_name(2, False, 0), ts.variant_name(0, True, 0),
                  ts.variant_name(1, True, 2)]
    sweeps_xdiv = [ts.variant_name(2, False, 0), ts.variant_name(1, True, 0),
                   ts.variant_name(0, True, 2, True)]
    species = [spm.variant_name(2, False), spm.variant_name(0, True),
               spm.variant_name(1, True)]
    pipe3 = ["pipe_a", "pipe_b", "pipe_c"]
    # the HIGHEST mode (x3d2_tpu's terms = 3): every sweep at W = 32
    hi = {"X3D2_MATMUL_PRECISION": "highest"}
    sweeps_zxy32 = [ts.variant_name(2, False, 0, w=32),
                    ts.variant_name(0, True, 0, w=32),
                    ts.variant_name(1, True, 2, w=32)]
    sweeps_rhs32 = sweeps_zxy32[:2] + [ts.variant_name(1, True, 0, w=32)]
    sweeps_xdiv32 = [ts.variant_name(2, False, 0, w=32),
                     ts.variant_name(1, True, 0, w=32),
                     ts.variant_name(0, True, 2, True, w=32)]
    species32 = [spm.variant_name(2, False, 32), spm.variant_name(0, True, 32),
                 spm.variant_name(1, True, 32)]

    def counts_now():
        return {**ts.launch_counts(), **oa.launch_counts(),
                **spm.launch_counts(), **td.launch_counts(),
                **xm.launch_counts()}

    # kernels a counted run launched at a size phase 3 did not hold them at
    unheld = set()

    def run_counted(tag, case, state, steps, per_step, per_run=()):
        """case.run for `steps` steps from `state`, with every launch count
        set to 0 just before and read just after. per_step names each
        kernel call of a step (a name once per call), per_run each call
        made once a run (the carry's boot z sweep); the counts must be
        exactly those. A kernel's entry in the kernels line takes the
        launches of the first path that runs it at that size. Returns
        (state, counts)."""
        torch.cuda.synchronize()
        ts.reset_launch_counts()
        oa.reset_launch_counts()
        spm.reset_launch_counts()
        td.reset_launch_counts()
        xm.reset_launch_counts()
        state = case.run(n_iters=steps, state=state, n_output=1, fresh=True)
        torch.cuda.synchronize()
        counts = counts_now()
        print(f"[{tag}] launches {counts}", flush=True)
        # the pipeline's stages launch the x-apply kernel, none the template
        on_tc = {k: v for k, v in xm.launch_counts().items() if k in PIPE_TC}
        on_tmpl = {k: v for k, v in oa.launch_counts().items()
                   if k in PIPE_TC}
        if on_tc:
            print(f"[{tag}] pipeline launches on the x-apply kernel {on_tc}",
                  flush=True)
        check(not on_tmpl, f"{tag}: pipeline launches on the template "
                           f"{on_tmpl}")
        # every launch of a sweep phase 3 held on the tensor-core body
        # (ts.tc_route of the same periodic operators) ran that body
        tc_want = {k: v for k, v in counts.items() if k in tc_names}
        tc_got = ts.tc_launch_counts()
        if tc_want:
            print(f"[{tag}] tensor-core sweep launches {tc_got}", flush=True)
        check(tc_got == tc_want, f"{tag}: tensor-core sweep launches "
                                 f"{tc_got}, expected {tc_want}")
        calls = Counter({name: steps * k
                         for name, k in Counter(per_step).items()})
        calls.update(per_run)
        want = {name: k * oa.LAUNCHES_PER_CALL.get(name, 1)
                for name, k in calls.items()}
        check(counts == want, f"{tag}: expected launches {want}, got "
                              f"{counts}")
        n = size_label(case.mesh.dims(DataLoc.VERT))
        for name in counts:
            if (name, n) not in rows:
                unheld.add(f"{name}@{n}")
            elif not rows[name, n]["launches"]:
                rows[name, n]["launches"] = counts[name]
        return state, counts

    def drive(tag, mesh_, params_, keep_pressure, steps, per_step,
              spy=None, fused=True, per_run=()):
        """One TGV run through TGVCase.run (run_counted). fused: the step
        takes a fused sweep chain (else the unfused AB step). Checks the
        counts, KE and the divergence, and with scalars phi and its
        variance. Returns (case, state, counts)."""
        t0 = time.perf_counter()
        case = TGVCase(mesh_, params_, dtype=torch.float32, monitor_path=None,
                       verbose=False, keep_pressure=keep_pressure, device=dev)
        check((case._fused_ab is not None or case._fused_rk is not None)
              == fused, f"{tag}: must {'' if fused else 'not '}take a fused "
                        "sweep chain")
        if spy is not None:
            spy(case)
        state = case.initial_state()
        var0 = phi_variance(state["phi"]) if "phi" in state else None
        dims = mesh_.dims(DataLoc.VERT)
        print(f"[{tag}] TGV {size_label(dims)} {params_.time_intg} "
              f"n_species={params_.n_species} keep_pressure={keep_pressure} "
              f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
        state, counts = run_counted(tag, case, state, steps, per_step,
                                    per_run)
        mon = case.monitor.rows
        ke = [r[4] for r in mon]
        ens = [r[1] for r in mon]
        div_max = max(r[2] for r in mon[1:])
        limit = DIV_LIMIT[max(dims)]
        print(f"[{tag}] ke {ke[0]:.10e} -> {ke[-1]:.10e}  enstrophy "
              f"{ens[0]:.8e} -> {ens[-1]:.8e}  div_u_max <= {div_max:.3e} "
              f"(limit {limit:g})", flush=True)
        check(all(math.isfinite(x) for x in ke + ens),
              f"{tag}: non-finite KE/enstrophy")
        check(all(b < a for a, b in zip(ke, ke[1:])),
              f"{tag}: KE must decrease")
        check(div_max < limit, f"{tag}: div_u_max {div_max} >= {limit}")
        if var0 is not None:
            var = phi_variance(state["phi"])
            print(f"[{tag}] phi variance (sum phi^2) {var0:.10e} -> "
                  f"{var:.10e} ({(var - var0) / var0:.3e})", flush=True)
            check(torch.isfinite(state["phi"]).all().item(),
                  f"{tag}: non-finite phi")
            check(var < var0, f"{tag}: the scalars' variance must fall")
        return case, state, counts

    def step_times(tag, case, state):
        """ms/step over steps after the first (monitoring off), and the
        share of the step in the sweep chains, the species sweeps and the
        projection (CUDA events on the step's own calls)."""
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = case.step(state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        step_ms = times[len(times) // 2]
        spread = times[0], times[-1]
        f = (state["u"], state["v"], state["w"])
        nsub, species_ms, divs = 1, 0.0, None
        chain = "sweeps"
        if case._fused_rk is None and case._fused_ab is None:
            # the unfused AB step: the transport (dense sweeps or dense
            # products), then ab_step and the hooks
            chain = "transport"
            chain_ms = cuda_ms(lambda: case.solver.transeq(*f), 10, torch)
        elif case._fused_rk is not None:
            nsub = len(case._fused_rk)
            ks, chain_ms = [], 0.0
            for istage, stage in enumerate(case._fused_rk):
                dtc = case.ti.rk_row(istage, DT)
                chain_ms += cuda_ms(lambda: stage(*f, f, ks, dtc), 10, torch)
                ks.append(stage(*f, f, ks, dtc)[1])
            del ks
        elif "rhsp" in state:
            # the d2-in-C carry: the chain without its z sweep, then the
            # pipeline with the carry (timed as the projection)
            chain = "sweeps x, y"
            scratch = tuple(tuple(o.clone() for o in p)
                            for p in state["olds"][:3])
            acc0 = tuple(r.clone() for r in state["rhsp"])
            dtc = ti.ab_row(3, DT, feedback=case._olds_dtype is not None)
            chain_ms = cuda_ms(lambda: case._fused_ab_nod2(
                *f, scratch, dtc, acc0), 10, torch)
            del scratch, acc0
        else:
            scratch = tuple(tuple(o.clone() for o in p)
                            for p in state["olds"][:3])
            dtc = ti.ab_row(3, DT, feedback=case._olds_dtype is not None)
            chain_ms = cuda_ms(lambda: case._fused_ab(*f, scratch, dtc), 10,
                               torch)
            if case._ab_is_xdiv:
                divs = case._fused_ab(*f, scratch, dtc)[2]
            del scratch
        if "phi" in state:
            species_ms = cuda_ms(lambda: case.solver.transeq_species_all(
                state["phi"], *f), 10, torch)
        if "comp" in state:
            # compensated: the gradients, added through the compensation
            proj_ms = cuda_ms(lambda: case.solver.pressure_grads(
                *f, keep_pressure=case.keep_pressure), 10, torch)
        elif "rhsp" in state:
            proj_ms = cuda_ms(lambda: case._pipe_d2c(*f), 10, torch)
        else:
            proj_ms = nsub * cuda_ms(lambda: case.solver.pressure_correction(
                *f, keep_pressure=case.keep_pressure, divs=divs), 10, torch)
        txt = (f"  species sweeps {species_ms:.3f} ms "
               f"({100 * species_ms / step_ms:.1f}%)" if "phi" in state
               else "")
        print(f"[{tag}] step {step_ms:.3f} ms (median of 10, host clock; "
              f"{spread[0]:.3f}-{spread[1]:.3f})  "
              f"{chain} {chain_ms:.3f} ms ({100 * chain_ms / step_ms:.1f}%)"
              f"{txt}  projection {proj_ms:.3f} ms "
              f"({100 * proj_ms / step_ms:.1f}%)", flush=True)
        return step_ms

    # 4. main path: 512^3, keep_pressure=False
    case, state, _ = drive("main", mesh, params, False, STEPS,
                           sweeps_zxy + pipe3)
    check(not case._ab_is_xdiv, "512^3 must not take the xdiv chain")
    modes_ms = {"main": step_times("main", case, state)}
    del case, state
    torch.cuda.empty_cache()

    # 4d. path D: the main path with the d2-in-C carry (X3D2_D2C=1): the
    # chain from the carried partials, pipe_a, pipe_b, pipe_c[d2]; one
    # boot z sweep a run (the partials made anew as the state enters run)
    sweeps_nod2 = sweeps_zxy[1:]
    carried = sweeps_nod2 + ["pipe_a", "pipe_b", "pipe_c[d2]"]
    with env_set({"X3D2_D2C": "1"}):
        case, state, _ = drive("path D", mesh, params, False, STEPS, carried,
                               per_run=[sweeps_zxy[0]])
    check(case._pipe_d2c is not None and "rhsp" in state,
          "path D must take the carry")
    # one carried step alone: no z sweep
    torch.cuda.synchronize()
    ts.reset_launch_counts()
    oa.reset_launch_counts()
    xm.reset_launch_counts()
    state = case.step(state)
    torch.cuda.synchronize()
    one = counts_now()
    print(f"[path D] launches in one carried step: {one} "
          f"({sweeps_zxy[0]}: {one.get(sweeps_zxy[0], 0)})", flush=True)
    check(one == {name: oa.LAUNCHES_PER_CALL.get(name, 1)
                  for name in carried},
          f"path D: a carried step launches {one}")
    modes_ms["path D"] = step_times("path D", case, state)
    del case, state
    torch.cuda.empty_cache()

    # 4e. paths DZ and MZ: 512 x 512 x 1024, with the carry (its streamed
    # form) and without it (the main path's chain at that grid)
    mesh_dz = Mesh(DZ, (2 * math.pi,) * 3, per)
    with env_set({"X3D2_D2C": "1"}):
        case, state, _ = drive("path DZ", mesh_dz, params, False, STEPS,
                               carried, per_run=[sweeps_zxy[0]])
    check(case._pipe_d2c is not None and "rhsp" in state,
          "path DZ must take the carry")
    modes_ms["path DZ"] = step_times("path DZ", case, state)
    del case, state
    torch.cuda.empty_cache()
    case, state, _ = drive("path MZ", mesh_dz, params, False, STEPS,
                           sweeps_zxy + pipe3)
    modes_ms["path MZ"] = step_times("path MZ", case, state)
    del case, state
    torch.cuda.empty_cache()
    print(f"[paths DZ, MZ] {size_label(DZ)}: the carry {modes_ms['path DZ']:.3f}"
          f" ms/step, without it {modes_ms['path MZ']:.3f} ms/step "
          f"({modes_ms['path MZ'] / modes_ms['path DZ']:.3f}x)", flush=True)
    torch.cuda.empty_cache()

    # 4b. the AB step's speed and accuracy modes at 512^3,
    # keep_pressure=False: path H, the bfloat16 history (X3D2_BF16_OLDS=1);
    # path HP, the bfloat16 partials alone (X3D2_BF16_ACC=1); path HA,
    # both; path K,
    # compensated stepping (the unfused step: the solver.transeq chain,
    # then pressure_grads on the slab kernels, no pipeline); and path M,
    # X3D2_MERGED_X=0 with keep_pressure=True, 3 steps
    sweeps_h = [ts.variant_name(2, False, 0), ts.variant_name(0, True, 0),
                ts.variant_name(1, True, 2, olds_bf16=True)]
    sweeps_hp = [ts.variant_name(2, False, 0, acc_bf16=True),
                 ts.variant_name(0, True, 0, acc_bf16=True),
                 ts.variant_name(1, True, 2, acc_bf16=True)]
    sweeps_ha = [ts.variant_name(2, False, 0, acc_bf16=True),
                 ts.variant_name(0, True, 0, acc_bf16=True),
                 ts.variant_name(1, True, 2, olds_bf16=True, acc_bf16=True)]
    for tag, env, names in (
            ("path H", {"X3D2_BF16_OLDS": "1"}, sweeps_h),
            ("path HP", {"X3D2_BF16_ACC": "1"}, sweeps_hp),
            ("path HA", {"X3D2_BF16_OLDS": "1", "X3D2_BF16_ACC": "1"},
             sweeps_ha)):
        with env_set(env):
            case, state, _ = drive(tag, mesh, params, False, STEPS,
                                   names + pipe3)
        hist = (torch.bfloat16 if "X3D2_BF16_OLDS" in env
                else torch.float32)
        check(all(o.dtype == hist for p_ in state["olds"] for o in p_),
              f"{tag}: the history must be {hist}")
        modes_ms[tag] = step_times(tag, case, state)
        del case, state
        torch.cuda.empty_cache()
    params_k = SolverParams(Re=1600.0, time_intg="AB3", dt=DT,
                            compensated=True)
    sweeps_rhs = [ts.variant_name(2, False, 0), ts.variant_name(0, True, 0),
                  ts.variant_name(1, True, 0)]
    case, state, _ = drive("path K", mesh, params_k, False, STEPS,
                           sweeps_rhs + ["x_div3", "pressure_mid[q]"]
                           + ["x_pinv"] * 3, fused=False)
    check(len(state["comp"]) == 3 and all(
        torch.isfinite(c).all().item() for c in state["comp"]),
        "path K: a finite compensation per velocity")
    modes_ms["path K"] = step_times("path K", case, state)
    del case, state
    torch.cuda.empty_cache()
    with env_set({"X3D2_MERGED_X": "0"}):
        case, state, _ = drive("path M", mesh, params, True, STEPS_R4,
                               sweeps_zxy + ["x_pfwd"] * 3
                               + ["pressure_mid[q]"] + ["x_pinv[sub]"] * 3)
        modes_ms["path M"] = step_times("path M", case, state)
    del case, state
    torch.cuda.empty_cache()
    # 4c. the HIGHEST mode at 512^3: path HI, the main path on the W = 32
    # sweeps; path HK, HIGHEST with compensated stepping (the
    # production-accuracy mode: the W = 32 sweeps without the update,
    # x_div3, the mid with q, 3 x_pinv). Only W = 32 sweeps launch.
    with env_set(hi):
        case, state, _ = drive("path HI", mesh, params, False, STEPS,
                               sweeps_zxy32 + pipe3)
    modes_ms["path HI"] = step_times("path HI", case, state)
    del case, state
    torch.cuda.empty_cache()
    with env_set(hi):
        case, state, _ = drive("path HK", mesh, params_k, False, STEPS,
                               sweeps_rhs32 + ["x_div3", "pressure_mid[q]"]
                               + ["x_pinv"] * 3, fused=False)
    check(all(torch.isfinite(c).all().item() for c in state["comp"]),
          "path HK: a finite compensation per velocity")
    modes_ms["path HK"] = step_times("path HK", case, state)
    del case, state
    torch.cuda.empty_cache()
    # path HIA: the HIGHEST mode with both bfloat16 streams (X3D2_BF16_OLDS=1,
    # X3D2_BF16_ACC=1): path HA's chain on the W = 32 instances
    sweeps_ha32 = [ts.variant_name(2, False, 0, acc_bf16=True, w=32),
                   ts.variant_name(0, True, 0, acc_bf16=True, w=32),
                   ts.variant_name(1, True, 2, olds_bf16=True, acc_bf16=True,
                                   w=32)]
    with env_set({**hi, "X3D2_BF16_OLDS": "1", "X3D2_BF16_ACC": "1"}):
        case, state, _ = drive("path HIA", mesh, params, False, STEPS,
                               sweeps_ha32 + pipe3)
    check(all(o.dtype == torch.bfloat16 for p_ in state["olds"] for o in p_),
          "path HIA: the history must be bfloat16")
    modes_ms["path HIA"] = step_times("path HIA", case, state)
    del case, state
    torch.cuda.empty_cache()
    print("[modes] 512^3 ms/step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in modes_ms.items()), flush=True)

    # 5. path B: 512^3, keep_pressure=True; path BS: with the mid's halves
    # (X3D2_MID_SPLIT=1); path BD: with the slab's dense forms
    # (X3D2_BFLY=0: the z, x, y chain, the dense x applies, the dense mid)
    last = {}

    def spy_projection(case):
        inner = case.solver.pressure_correction

        def spy(u, v, w, keep_pressure=True, divs=None):
            last["in"] = (u, v, w)
            return inner(u, v, w, keep_pressure=keep_pressure, divs=divs)

        object.__setattr__(case.solver, "pressure_correction", spy)

    ns64 = NavierStokes.build(mesh, nu, dtype=d64, device=dev)
    for tag, env, per_step in (
            ("path B", {}, sweeps_zxy + ["x_div3", "pressure_mid[q]",
                                         "x_gradsub3"]),
            ("path BS", {"X3D2_MID_SPLIT": "1"},
             sweeps_zxy + ["x_div3", "div_solve", "grad", "x_gradsub3"]),
            ("path BD", {"X3D2_BFLY": "0"},
             sweeps_zxy + ["x_apply"] * 3 + ["pressure_mid[q,dense]"]
             + ["x_apply[sub]"] * 3)):
        with env_set(env):
            case, state, _ = drive(tag, mesh, params, True, STEPS, per_step,
                                   spy=spy_projection)
            p = state["p"]
            p_ref = case.solver.pressure_grads_folded(*last["in"],
                                                      keep_pressure=True)[3]
            err_p, _ = rel_err([p], [p_ref])
            tol_p = p_tolerance(p_ref, last["in"])
            # for the record: both float32 formulations against the float64
            # one
            p64 = ns64.pressure_grads_folded(*to64(last["in"]),
                                             keep_pressure=True)[3]
            _, rel_k64 = rel_err([p], [p64])
            _, rel_f64 = rel_err([p_ref], [p64])
            print(f"[{tag}] physical p of the last step vs the folded chain: "
                  f"max|dp| {err_p:.3e} (<= {tol_p:.3e} = 1e-5 max|p| + 4 "
                  f"eps max|u'|), max|p| {float(p_ref.abs().max()):.3e}; "
                  f"against the float64 folded chain: kernels rel "
                  f"{rel_k64:.2e}, float32 folded chain rel {rel_f64:.2e}",
                  flush=True)
            check(torch.isfinite(p).all().item() and err_p <= tol_p,
                  f"{tag}: pressure differs by {err_p} (limit {tol_p})")
            del p_ref, p, p64
            last.clear()
            object.__delattr__(case.solver, "pressure_correction")
            modes_ms[tag] = step_times(tag, case, state)
        del case, state
        torch.cuda.empty_cache()
    del ns64
    torch.cuda.empty_cache()
    print("[modes] 512^3 ms/step, the projection switches: " + ", ".join(
        f"{k} {modes_ms[k]:.3f}" for k in ("main", "path D", "path B",
                                            "path BS", "path BD")),
        flush=True)
    print(f"[path BD] {modes_ms['path BD']:.3f} ms/step; PR 11's final run "
          f"{PR11_MS['path BD']:.3f} ({card})", flush=True)

    # 6. path A: 256^3, keep_pressure=False: the xdiv chain and the slab
    names_a = sweeps_xdiv + ["pressure_mid", "x_gradsub3"]
    case, state, _ = drive("path A", mesh_a, params, False, STEPS_A, names_a)
    check(case._ab_is_xdiv, "256^3 must take the xdiv chain")
    first = tuple(state[k].clone() for k in ("u", "v", "w"))
    ms_xdiv = step_times("path A", case, state)
    del case, state
    case, state, _ = drive("path A again", mesh_a, params, False, STEPS_A,
                           names_a)
    same = all(torch.equal(a, state[k])
               for a, k in zip(first, ("u", "v", "w")))
    print(f"[path A] second run from the same initial state: u, v, w "
          f"bit-identical: {same}", flush=True)
    check(same, "path A: two runs differ")
    del case, state, first
    torch.cuda.empty_cache()
    os.environ["X3D2_XDIV_FUSED"] = "0"
    try:
        case, state, _ = drive("256^3 X3D2_XDIV_FUSED=0", mesh_a, params,
                               False, STEPS_A, sweeps_zxy + pipe3)
        check(not case._ab_is_xdiv, "X3D2_XDIV_FUSED=0 must switch xdiv off")
        ms_pipe = step_times("256^3 X3D2_XDIV_FUSED=0", case, state)
    finally:
        del os.environ["X3D2_XDIV_FUSED"]
    del case, state
    torch.cuda.empty_cache()
    # path AI: the xdiv chain in the HIGHEST mode, on the W = 32 sweeps
    with env_set(hi):
        case, state, _ = drive("path AI", mesh_a, params, False, STEPS_A,
                               sweeps_xdiv32 + ["pressure_mid",
                                                "x_gradsub3"])
    check(case._ab_is_xdiv, "path AI must take the xdiv chain")
    ms_ai = step_times("path AI", case, state)
    print(f"[path A] 256^3 ms/step: xdiv chain + slab {ms_xdiv:.3f}, z-x-y "
          f"chain + pipeline {ms_pipe:.3f}, xdiv chain in the HIGHEST mode "
          f"(path AI) {ms_ai:.3f}", flush=True)
    del case, state
    torch.cuda.empty_cache()

    # 7. passive scalars and Runge-Kutta
    case, state, _ = drive("path S", mesh, params_s, False, STEPS,
                           sweeps_zxy + species + pipe3)
    check(not case._ab_is_xdiv, "512^3 must not take the xdiv chain")
    step_times("path S", case, state)
    del case, state
    torch.cuda.empty_cache()

    cfg = config.Config.from_file(EXAMPLE)
    check(cfg.solver.n_species == 2 and tuple(cfg.solver.pr_species) == PR
          and tuple(cfg.domain.dims_global) == SMALL,
          f"{EXAMPLE}: unexpected configuration {cfg}")
    case, state, _ = drive("path S-ex", Mesh.from_config(cfg.domain),
                           cfg.solver, False, STEPS_A,
                           sweeps_xdiv + species + ["pressure_mid",
                                                    "x_gradsub3"])
    check(case._ab_is_xdiv, "the example grid must take the xdiv chain")
    step_times("path S-ex", case, state)
    del case, state
    torch.cuda.empty_cache()

    params_r = SolverParams(Re=1600.0, time_intg="RK3", dt=DT)
    zx = [ts.variant_name(2, False, 0), ts.variant_name(0, True, 0)]
    rk_y = [ts.variant_name(1, True, nolds, upd=True, base_sep=istage > 0)
            for istage, nolds in enumerate([0, 0, 2])]
    case, state, _ = drive("path R", mesh, params_r, False, STEPS,
                           zx * 3 + rk_y + pipe3 * 3)
    check(case._fused_rk is not None, "path R must take the fused RK chain")
    step_times("path R", case, state)
    del case, state
    torch.cuda.empty_cache()
    params_r4 = SolverParams(Re=1600.0, time_intg="RK4", dt=DT)
    rk4_y = [ts.variant_name(1, True, nolds, upd=True, base_sep=istage > 0)
             for istage, nolds in enumerate([0, 0, 0, 3])]
    case, state, _ = drive("path R4", mesh, params_r4, False, STEPS_R4,
                           zx * 4 + rk4_y + pipe3 * 4)
    del case, state
    torch.cuda.empty_cache()
    # paths RI and R4I: RK3 and RK4 fused in the HIGHEST mode, 3 steps
    zx32 = sweeps_zxy32[:2]
    for tag, prm, nolds_rows in (("path RI", params_r, [0, 0, 2]),
                                 ("path R4I", params_r4, [0, 0, 0, 3])):
        rk_y32 = [ts.variant_name(1, True, k, upd=True, base_sep=i > 0, w=32)
                  for i, k in enumerate(nolds_rows)]
        with env_set(hi):
            case, state, _ = drive(tag, mesh, prm, False, STEPS_R4,
                                   zx32 * len(nolds_rows) + rk_y32
                                   + pipe3 * len(nolds_rows))
        del case, state
        torch.cuda.empty_cache()

    # path T128: 128^3, the dense sweeps and the unfused AB step
    dense3 = [td.variant_name(a) for a in range(3)]
    mesh_t = Mesh(shape_t, (2 * math.pi,) * 3, per)
    case, state, _ = drive("path T128", mesh_t, params, False, STEPS_A,
                           dense3 + pipe3, fused=False)
    check(case.solver._v1 is not None, "path T128 must take the dense sweeps")
    step_times("path T128", case, state)
    del case, state
    torch.cuda.empty_cache()

    # 7d. the tails' paths, keep_pressure=False but PYB: PX 320 x 256 x 384
    # (the z, x, y sweep chain and the pipeline, its x applies in the
    # general instance), PY 384 x 192 x 384 (x3d2_tpu's einsum transport,
    # plain matrix products, and the pipeline: its y applies in the general
    # instance), PYB (PY with the pressure kept: x_div3, the mid with q,
    # x_gradsub3), YD 256 x 200 x 256 (the einsum transport and the slab
    # on the folded y: x_div3, the mid without q in 4 launches, x_gradsub3)
    tails_ms = {}
    slab_q = ["x_div3", "pressure_mid[q]", "x_gradsub3"]
    for tag, dims, keep, per_step, fused in (
            ("path PX", PX, False, sweeps_zxy + pipe3, True),
            ("path PY", PY, False, pipe3, False),
            ("path PYB", PY, True, slab_q, False),
            ("path YD", YD, False, ["x_div3", "pressure_mid[folded_y]",
                                    "x_gradsub3"], False)):
        mesh_x = Mesh(dims, (2 * math.pi,) * 3, per)
        case, state, _ = drive(tag, mesh_x, params, keep, STEPS, per_step,
                               spy=spy_projection if keep else None,
                               fused=fused)
        check(case.solver._projection_gap is None
              and not case._ab_is_xdiv, f"{tag}: the branch x3d2_tpu takes")
        if keep:
            p = state["p"]
            p_ref = case.solver.pressure_grads_folded(*last["in"],
                                                      keep_pressure=True)[3]
            err_p, _ = rel_err([p], [p_ref])
            tol_p = p_tolerance(p_ref, last["in"])
            print(f"[{tag}] physical p of the last step vs the folded chain: "
                  f"max|dp| {err_p:.3e} (<= {tol_p:.3e}), max|p| "
                  f"{float(p_ref.abs().max()):.3e}", flush=True)
            check(torch.isfinite(p).all().item() and err_p <= tol_p,
                  f"{tag}: pressure differs by {err_p} (limit {tol_p})")
            del p, p_ref
            last.clear()
            object.__delattr__(case.solver, "pressure_correction")
        tails_ms[tag] = step_times(tag, case, state)
        del case, state
        torch.cuda.empty_cache()
    print("[tails] ms/step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in tails_ms.items()), flush=True)

    # 7c. tools/prof_manual.py, the manual x apply's entry point, once at
    # 512^3: its launches are the kernels line's for x_apply_manual
    stamp("phase 7c (tools/prof_manual.py)")
    torch.cuda.synchronize()
    xm.reset_launch_counts()
    prof, prof_ok = pmt.profile(NS, 20, dev=dev)
    torch.cuda.synchronize()
    prof_counts = xm.launch_counts()
    print(json.dumps({"prof_manual": {"card": card, "shape": [NS] * 3,
                                      "forms": prof, "ok": prof_ok}}),
          flush=True)
    check(prof_ok, "prof_manual: a kernel differs from the plain versions")
    for label, parity, sub in pmt.FORMS:
        e = prof[label]
        cost = (x_apply_cost(NS, NS, NS, NS, sub) if parity is None
                else x_parity_cost((NS,) * 3, sub))
        b_tc = bound(*cost, tc=True)[0]
        ms_s = {S: e[f"manual[S={S}]"]["ms"] for S in pmt.SLOTS}
        check(all(b_tc <= t for t in ms_s.values()),
              f"prof_manual {label}: a time beats its bound")
        tmpl = (f", template {e['template']['ms']:.3f}" if "template" in e
                else "")
        print(f"[prof_manual {label} {NS}] ms " + ", ".join(
            f"S={S} {t:.3f} ({b_tc / t:.0%})" for S, t in ms_s.items())
            + f"{tmpl}; torch {e['torch_ms']:.3f}; split-TF32 bound "
            f"{b_tc:.3f}, FP32 bound {bound(*cost)[0]:.3f}; vs plain64 rel "
            f"{e['manual[S=4]']['rel64']:.2e}, plain32 vs plain64 "
            f"{e['plain32_vs_64']:.2e}", flush=True)
    for name, k in prof_counts.items():
        if (name, str(NS)) not in rows:
            unheld.add(f"{name}@{NS}")
        else:
            rows[name, str(NS)]["launches"] = k
    del prof
    torch.cuda.empty_cache()

    # 7b. the cylinder through the port's config.py
    stamp("phase 7b (the cylinder)")
    def drive_cylinder(tag, dims, steps, per_step):
        cfg_ = config.Config.from_file(CYL_EXAMPLE)
        cfg_.domain.dims_global = dims
        t0 = time.perf_counter()
        case = config.make_case(cfg_, monitor_path=None, verbose=False,
                                keep_pressure=False, device=dev)
        check(isinstance(case, CylinderCase) and case._fused_ab is None
              and case.solver._transport == "dense",
              f"{tag}: the cylinder steps unfused on the dense transport")
        state = case.initial_state()
        print(f"[{tag}] cylinder {size_label(dims)} AB3 ibm_on="
              f"{case.params.ibm_on} keep_pressure=False set-up "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        state, _ = run_counted(tag, case, state, steps, per_step)
        fin = all(torch.isfinite(state[k]).all().item() for k in "uvw")
        mon = case.monitor.rows
        div_max = max(r[2] for r in mon[1:])
        inflow = float(state["u"][0].mean())
        # the body's centre: the vertex line nearest (Lx/2, Ly/2)
        ic, jc = (round(case.mesh.L[a] / 2 / case.mesh.d[a]) for a in (0, 1))
        centre = float(state["u"][ic, jc].abs().max())
        print(f"[{tag}] finite {fin}  ke {mon[0][4]:.10e} -> "
              f"{mon[-1][4]:.10e}  inflow plane mean u {inflow:.6f} (within "
              f"0.1 of 1)  max |u| at the body's centre {centre:.3e} (< 0.5)"
              f"  div_u_max <= {div_max:.3e}", flush=True)
        check(fin, f"{tag}: non-finite velocities")
        check(abs(inflow - 1.0) < 0.1, f"{tag}: inflow plane mean {inflow}")
        check(centre < 0.5, f"{tag}: |u| at the body's centre {centre}")
        return case, state, div_max

    case, state, div_max = drive_cylinder(
        "path C", CYL, STEPS, ["x_apply"] * 3 + ["x_apply[sub]"] * 3
        + ["pressure_mid"])
    check(case.solver._slab.x_perm is None and case.ep is not None,
          "path C: the dense x stage and the IBM mask")
    print(f"[path C] div_u_max {div_max:.3e} (limit {CYL_DIV_LIMIT:g})",
          flush=True)
    check(div_max < CYL_DIV_LIMIT,
          f"path C: div_u_max {div_max} >= {CYL_DIV_LIMIT}")
    ms_c = step_times("path C", case, state)
    print(f"[path C] {ms_c:.3f} ms/step; PR 11's final run "
          f"{PR11_MS['path C']:.3f} ({card})", flush=True)
    del case, state
    torch.cuda.empty_cache()
    case, state, _ = drive_cylinder("path C-ex", (257, 128, 32), STEPS, [])
    check(case.solver._slab is None and case.solver._projection_gap is None,
          "path C-ex: the folded chain, as x3d2_tpu")
    del case, state
    torch.cuda.empty_cache()

    # ---- 8. slice as a whole: card vs CPU ---------------------------------
    stamp("phase 8 (card vs CPU)")
    x16 = [ts.variant_name(2, False, 0), ts.variant_name(1, True, 0),
           ts.variant_name(0, True, 2, True, olds_bf16=True)]
    x16p = [ts.variant_name(2, False, 0, acc_bf16=True),
            ts.variant_name(1, True, 0, acc_bf16=True),
            ts.variant_name(0, True, 2, True, acc_bf16=True)]
    x16a = [ts.variant_name(2, False, 0, acc_bf16=True),
            ts.variant_name(1, True, 0, acc_bf16=True),
            ts.variant_name(0, True, 2, True, olds_bf16=True,
                            acc_bf16=True)]
    slab_tail = ["pressure_mid", "x_gradsub3"]
    grads = ["x_div3", "pressure_mid[q]"] + ["x_pinv"] * 3
    x16_32 = [ts.variant_name(2, False, 0, w=32),
              ts.variant_name(1, True, 0, w=32),
              ts.variant_name(0, True, 2, True, olds_bf16=True, w=32)]
    x16p_32 = [ts.variant_name(2, False, 0, acc_bf16=True, w=32),
               ts.variant_name(1, True, 0, acc_bf16=True, w=32),
               ts.variant_name(0, True, 2, True, acc_bf16=True, w=32)]
    pipe_d2 = ["pipe_a", "pipe_b", "pipe_c[d2]"]
    dense_x, dense_sub = ["x_apply"] * 3, ["x_apply[sub]"] * 3
    halves = ["div_solve", "grad"]
    dmid = "pressure_mid[q,dense]"
    # the card legs counted as the paths' (a kernel's launches a step);
    # the other chains' card legs are not counted
    small_counts = {
        "xdiv path, bfloat16 history": x16 + slab_tail,
        "xdiv path, bfloat16 partials": x16p + slab_tail,
        "xdiv path, bfloat16 history and partials": x16a + slab_tail,
        "X3D2_XDIV_FUSED=0, bfloat16 history": sweeps_h + pipe3,
        "compensated + 2 species, bfloat16 history":
            sweeps_rhs + species + grads,
        "X3D2_MERGED_X=0, keep_pressure=True, X3D2_XDIV_FUSED=0":
            sweeps_zxy + ["x_pfwd"] * 3 + ["pressure_mid[q]"]
            + ["x_pinv[sub]"] * 3,
        "HIGHEST, xdiv path": sweeps_xdiv32 + slab_tail,
        "HIGHEST, compensated": sweeps_rhs32 + grads,
        "HIGHEST, RK3 + 2 species (unfused)":
            (sweeps_rhs32 + species32 + pipe3) * 3,
        "HIGHEST, xdiv path, bfloat16 history": x16_32 + slab_tail,
        "HIGHEST, xdiv path, bfloat16 partials": x16p_32 + slab_tail,
        "X3D2_D2C=1, X3D2_XDIV_FUSED=0": sweeps_nod2 + pipe_d2,
        "X3D2_D2C=1, X3D2_XDIV_FUSED=0, HIGHEST":
            sweeps_zxy32[1:] + pipe_d2,
        "X3D2_D2C=1, X3D2_XDIV_FUSED=0, bfloat16 history":
            sweeps_h[1:] + pipe_d2,
        "X3D2_MID_SPLIT=1, xdiv path": sweeps_xdiv + halves + ["x_gradsub3"],
        "X3D2_MID_SPLIT=1, keep_pressure=True":
            sweeps_xdiv + halves + ["x_gradsub3"],
        "X3D2_BFLY=0, keep_pressure=True":
            sweeps_zxy + dense_x + [dmid] + dense_sub,
        "X3D2_BFLY=0, keep_pressure=False": sweeps_zxy + pipe3,
        "X3D2_BFLY=0, compensated": sweeps_rhs + dense_x + [dmid] + dense_x,
        "X3D2_MID_SPLIT=1, X3D2_BFLY=0, keep_pressure=True":
            sweeps_zxy + dense_x + ["div_solve[dense]", "grad[dense]"]
            + dense_sub,
        "X3D2_BFLY=0, X3D2_PIPE3=0":
            sweeps_zxy + dense_x + ["pressure_mid[dense]"] + dense_sub}
    counted = {f"{SMALL} {k}": v for k, v in small_counts.items()}
    counted[f"cylinder {size_label(CYL_SMALL)} compensated"] = \
        ["x_apply"] * 6 + ["pressure_mid[q]"]
    counted[f"cylinder {size_label(CYL_SMALL)} X3D2_MID_SPLIT=1"] = \
        dense_x + halves + dense_sub
    # the carry's streamed form at nz = 640
    counted[f"{D640} X3D2_D2C=1: the streamed carry"] = \
        sweeps_nod2 + pipe_d2
    # the carry's chains launch one boot z sweep a run
    boots = {s_["label"]: [ts.variant_name(2, False, 0, w=32 if (
        "X3D2_MATMUL_PRECISION" in s_["env"]) else 16)]
        for s_ in chain_specs if "X3D2_D2C" in s_["env"]}
    check(set(counted) <= {s_["label"] for s_ in chain_specs},
          f"counted chains phase 8 lacks: {sorted(counted)}")

    # CPU legs bit-identical to an earlier chain's (CPU_SAME) are that
    # chain's; each chain of a pair has the switches and keep_pressure its
    # label names
    cpu_same = {chain_label(a): chain_label(b) for a, b in CPU_SAME}
    shorts = {chain_label(x): x for pair in CPU_SAME for x in pair}
    for s_ in chain_specs:
        if s_["label"] in shorts:
            check(chain_switches(shorts[s_["label"]])[1:]
                  == (s_["env"], s_["keep"]),
                  f"{s_['label']}: the chain's switches {s_['env']}, "
                  f"keep_pressure {s_['keep']} are not those its label "
                  "names")
    check(set(shorts) <= {s_["label"] for s_ in chain_specs},
          f"CPU_SAME names a chain phase 8 lacks: {sorted(shorts)}")
    ab3 = TimeIntegrator("AB3")
    # |c_j| of every coefficient a rounded value meets, and the feedback's
    coeff_sum = float(sum(abs(c) for c in ab3.ab_row(3, 1.0))) + abs(
        ab3.future_coeff_sum())
    t_wait = 0.0
    for spec in chain_specs:
        label, keep, nround = spec["label"], spec["keep"], spec["nround"]
        steps = spec.get("steps", CHAIN_STEPS)
        per_step = counted.get(label)
        t_chain = time.perf_counter()
        with env_set(spec["env"]):
            c = chain_case(spec, "cuda")
            took = chain_took(c)
            check(took == spec["chain"], f"{label}: took the {took} chain, "
                                         f"not {spec['chain']}")
            torch.cuda.synchronize()
            t_card = time.perf_counter()
            if per_step is not None:
                on_card, _ = run_counted(label, c, c.initial_state(),
                                         steps, per_step,
                                         boots.get(label, ()))
            else:
                on_card = c.run(n_iters=steps, n_output=steps)
            torch.cuda.synchronize()
            t_card = (time.perf_counter() - t_card) * 1e3 / steps
            card_ke = c.monitor.rows[-1][4]
        del c
        t0 = time.perf_counter()
        files, cpu_ke, cpu_took, rmax, cpu_s = cpu_legs[
            cpu_same.get(label, label)].get()
        t_wait += time.perf_counter() - t0
        check(cpu_took == spec["chain"], f"{label}: the CPU leg took the "
                                         f"{cpu_took} chain")
        cpu = {k: torch.from_numpy(np.load(f)) for k, f in files.items()}
        du = max(float((on_card[k].cpu() - cpu[k]).abs().max())
                 for k in ("u", "v", "w"))
        ke_rel = abs(card_ke - cpu_ke) / abs(cpu_ke)
        # a bfloat16 store rounds to the neighbouring value where card and
        # CPU differ by a float32 ulp: one bfloat16 ulp (2^-7 of the value,
        # at most of the largest rhs or partial R) entering u' through
        # dt |c_j| (and the feedback), for each rounded stream, each step
        extra, txt = 0.0, ""
        if nround:
            extra = nround * steps * DT * coeff_sum * BF16_ULP * rmax
            txt = f"  bfloat16 stores: + {extra:.3e} (R {rmax:.3e})"
        vel = sum(float(cpu[k].abs().mean()) for k in ("u", "v", "w"))
        du_tol = 1e-5 + extra
        ke_tol = 1e-6 + extra * vel / cpu_ke
        if keep:
            p_cpu = cpu["p"]
            p_err, _ = rel_err([on_card["p"].cpu()], [p_cpu])
            p_tol = p_tolerance(p_cpu, [cpu[k] for k in ("u", "v", "w")])
            txt += f"  max|dp| {p_err:.3e} (<= {p_tol:.3e}, max|p| " \
                   f"{float(p_cpu.abs().max()):.3e})"
            check(p_err <= p_tol, f"card vs CPU pressure difference {p_err}")
        if "phi" in cpu:
            dphi = float((on_card["phi"].cpu() - cpu["phi"]).abs().max())
            txt += f"  max|dphi|={dphi:.3e} (<= {du_tol:.3e})"
            check(dphi <= du_tol, f"{label}: card vs CPU phi difference "
                                  f"{dphi}")
        if label in cpu_same:
            txt += f"  (CPU leg: that of {cpu_same[label]})"
        txt += (f"  ({time.perf_counter() - t_chain:.1f} s; the card "
                f"{t_card:.3f} ms/step with monitoring; the CPU leg "
                f"{cpu_s:.1f} s)")
        if label == "cylinder 65x128x128 compensated":
            txt += ("  (PR 11's log: the leg 0.2 s, set-up, 10 steps and "
                    "compare)")
        print(f"[slice] {label}, {steps} steps card vs CPU: "
              f"max|du,dv,dw|={du:.3e} (<= {du_tol:.3e})  KE rel "
              f"{ke_rel:.3e} (<= {ke_tol:.3e}){txt}", flush=True)
        check(du <= du_tol, f"{label}: card vs CPU velocity difference {du}")
        check(ke_rel <= ke_tol, f"{label}: card vs CPU KE difference "
                                f"{ke_rel}")
        del on_card, cpu
    cpu_pool.close()
    cpu_pool.join()
    shutil.rmtree(legs_dir)
    print(f"[slice] the CPU legs ({len(cpu_legs)} in {CPU_LEG_WORKERS} "
          f"processes, one thread each, since phase 3) kept phase 8 waiting "
          f"{t_wait:.1f} s", flush=True)

    # ---- 8q. the paths' step times on a quiet host ------------------------
    # phases 4-7 timed their steps with the CPU legs running on 7 of the
    # host's cores; with the legs done, the main path and the tails' paths
    # again, beside what was read with them
    stamp("phase 8q (step times on a quiet host)")
    busy = {"main": modes_ms["main"], **tails_ms}
    quiet = {}
    for tag, dims, keep in (("main", (NS,) * 3, False),
                            ("path PX", PX, False), ("path PY", PY, False),
                            ("path PYB", PY, True), ("path YD", YD, False)):
        case = TGVCase(Mesh(dims, (2 * math.pi,) * 3, per), params,
                       dtype=torch.float32, monitor_path=None, verbose=False,
                       keep_pressure=keep, device=dev)
        state = case.initial_state()
        for _ in range(3):
            state = case.step(state)
        quiet[tag] = step_times(f"{tag}, quiet host", case, state)
        del case, state
        torch.cuda.empty_cache()
    print("[quiet host] ms/step with the CPU legs running -> without: "
          + ", ".join(f"{k} {busy[k]:.3f} -> {v:.3f} ({busy[k] / v:.3f}x)"
                      for k, v in quiet.items()), flush=True)

    # ---- 8b. KE against float64 in the HIGHEST mode -------------------------
    stamp("phase 8b (KE, HIGHEST + compensated vs float64)")
    from x3d2_tpu_torch.tools import ke_parity as kp
    with env_set(hi):
        s32, k32, ms32, _ = kp.run_curve(SMALL, torch.float32, True, dev,
                                         KE_T, log=lambda msg: None)
    with env_set({"X3D2_PALLAS": "0"}):
        s64, k64, ms64, _ = kp.run_curve(SMALL, d64, False, dev, KE_T,
                                         log=lambda msg: None)
    ke_rel, ke_t, _ = kp.compare(s32, k32, s64, k64)
    print(f"[ke] TGV {size_label(SMALL)} to t = {KE_T:g}: HIGHEST + "
          f"compensated float32 ({ms32:.3f} ms/step) vs the float64 einsum "
          f"leg ({ms64:.3f} ms/step): max |dKE|/KE0 {ke_rel:.3e} at t = "
          f"{ke_t:.2f} (<= {KE_LIMIT:g})", flush=True)
    check(math.isfinite(ke_rel) and ke_rel <= KE_LIMIT,
          f"KE of the HIGHEST compensated run vs float64: {ke_rel}")

    # ---- 9. the sharded step ------------------------------------------------
    stamp("phase 9 (the sharded step)")
    from x3d2_tpu_torch.tools import shard_run
    ncard = torch.cuda.device_count()
    transport = "nccl" if ncard >= 4 else "gloo"
    print(f"[sharded] transport {transport}: " + (
        "one card per rank, rank r on cuda:r" if transport == "nccl" else
        f"{ncard} card, all 4 ranks on cuda:0, the halo planes and the "
        "all-to-all buffers staged through host memory (gloo takes CPU "
        "tensors): the kernels and the arithmetic of a 4-rank run, not "
        "multi-card communication"), flush=True)

    def sharded_launches(w, mesh_s, scalars, dense=False, tiled=False):
        """The per-rank kernel calls of one sharded AB step (an RK
        substage): the z, x + acc, y + acc sweeps (the halo form on a
        sharded axis; and the scalars'), 3 x_pfwd, the local mid (6
        launches; tiled: the tiled mid's 3), 3 x_pinv[sub]; with
        X3D2_BFLY=0 (dense) 3 x_apply, the dense local mid, 3
        x_apply[sub]."""
        halo = {1: mesh_s[0] > 1, 2: mesh_s[1] > 1, 0: False}
        out = [ts.variant_name(a, a != 2, 0, w=w, halo=halo[a])
               for a in (2, 0, 1)]
        if scalars:
            out += [spm.variant_name(a, a != 2, w, halo=halo[a])
                    for a in (2, 0, 1)]
        if dense:
            return out + ["x_apply"] * 3 + ["pressure_mid[q,dense,local]"] \
                + ["x_apply[sub]"] * 3
        mid = (list(sl.TILED_STAGES) if tiled
               else ["pressure_mid[q,local]"])
        return out + ["x_pfwd"] * 3 + mid + ["x_pinv[sub]"] * 3

    base = {"device": "cuda", "backend": transport, "dtype": "float32",
            "reference": True}
    sh_runs = [
        ("main sharded path: TGV 512^3 AB3 float32 keep_pressure=False",
         {"dims": (NS,) * 3, "mesh": (2, 2), "warmup": 2, "steps": 3},
         sharded_launches(ts.W, (2, 2), False)),
        # 1024^2 planes: the repencilled projection takes the tiled mid
        (f"TGV {size_label(SHARD_TILED)} AB3 float32 keep_pressure=False "
         "(the tiled mid)",
         {"dims": SHARD_TILED, "mesh": (2, 2), "warmup": 1, "steps": 2},
         sharded_launches(ts.W, (2, 2), False, tiled=True)),
        # the tiled mid's long form: 2048 points along y (SH-ty), along z
        # (SH-tz)
        (f"TGV {size_label(SHARD_TY)} AB3 float32 keep_pressure=False "
         "(SH-ty: the tiled mid, 2048 points along y)",
         {"dims": SHARD_TY, "mesh": (2, 2), "steps": 3},
         sharded_launches(ts.W, (2, 2), False, tiled=True)),
        (f"TGV {size_label(SHARD_TZ)} AB3 float32 keep_pressure=False "
         "(SH-tz: the tiled mid, 2048 points along z)",
         {"dims": SHARD_TZ, "mesh": (2, 2), "steps": 3},
         sharded_launches(ts.W, (2, 2), False, tiled=True)),
        (f"TGV {size_label(SHARD_SMALL)} AB3, 2 scalars",
         {"dims": SHARD_SMALL, "mesh": (2, 2), "steps": SHARD_STEPS,
          "n_species": 2, "pr": PR},
         sharded_launches(ts.W, (2, 2), True)),
        (f"TGV {size_label(SHARD_SMALL)} AB3, 2 scalars, HIGHEST",
         {"dims": SHARD_SMALL, "mesh": (2, 2), "steps": SHARD_STEPS,
          "n_species": 2, "pr": PR, "env": hi},
         sharded_launches(32, (2, 2), True)),
        (f"TGV {size_label(SHARD_Z)} AB3", {"dims": SHARD_Z, "mesh": (1, 4),
                                            "steps": SHARD_STEPS},
         sharded_launches(ts.W, (1, 4), False)),
        # the branches a user opens beside the main one: the unfused RK
        # step (X3D2_FUSED_RK=0) with the physical pressure, and the dense
        # x stage and mid (X3D2_BFLY=0), each with its p held too
        (f"TGV {size_label(SHARD_SMALL)} RK3 (X3D2_FUSED_RK=0), "
         "keep_pressure=True",
         {"dims": SHARD_SMALL, "mesh": (2, 2), "steps": 3,
          "time_intg": "RK3", "keep_pressure": True,
          "env": {"X3D2_FUSED_RK": "0"}},
         sharded_launches(ts.W, (2, 2), False) * 3),
        (f"TGV {size_label(SHARD_SMALL)} AB3, X3D2_BFLY=0, "
         "keep_pressure=True",
         {"dims": SHARD_SMALL, "mesh": (2, 2), "steps": SHARD_STEPS,
          "keep_pressure": True, "env": {"X3D2_BFLY": "0"}},
         sharded_launches(ts.W, (2, 2), False, dense=True))]
    t0 = time.perf_counter()
    sh_res = shard_run.run_many([{**base, **spec} for _, spec, _ in sh_runs],
                                threads=2)
    print(f"[sharded] 4 ranks spawned, {len(sh_runs)} runs: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for (label, spec, per_step), res in zip(sh_runs, sh_res):
        mesh_s, dims = spec["mesh"], tuple(spec["dims"])
        tag = f"sharded {label} on {mesh_s}"
        lab = size_label((dims[0], dims[1] // mesh_s[0],
                          dims[2] // mesh_s[1]))
        want = {name: spec["steps"] * k * oa.LAUNCHES_PER_CALL.get(name, 1)
                for name, k in Counter(per_step).items()}
        tiled = tuple(dims) in (SHARD_TILED,) + SHARD_LONG
        for r in res:
            ms, comm = r["ms_per_step"], r["comm_ms_per_step"]
            print(f"[{tag}] rank {r['rank']} on {r['device']} "
                  f"({r['backend']}): {ms:.3f} ms/step (host clock, the "
                  f"device synchronised), halo exchanges {comm['halo']:.3f} "
                  f"ms ({comm['halo'] / ms:.1%}), all-to-alls "
                  f"{comm['a2a']:.3f} ms ({comm['a2a'] / ms:.1%}); launches "
                  f"{r['counts']}", flush=True)
            check(r["counts"] == want, f"{tag} rank {r['rank']}: expected "
                                       f"launches {want}, got {r['counts']}")
            check(r["solver"] == {"_sharded_transeq": True,
                                  "_sharded_species": bool(
                                      spec.get("n_species")),
                                  "_repencil_pressure": True,
                                  "_halo_mode": True}
                  and r["dense_mid"] == ("X3D2_BFLY" in spec.get("env", {}))
                  and r["mid"] == ("mid_tiled" if tiled else "mid_local"),
                  f"{tag}: the branches {r['solver']}, dense mid "
                  f"{r['dense_mid']}, mid {r['mid']}")
        print(f"[{tag}] rank 0's seconds: " + ", ".join(
            f"{k} {v:.1f}" for k, v in res[0]["seconds"].items()),
            flush=True)
        if "X3D2_BFLY" in spec.get("env", {}):
            print(f"[{tag}] SH-d: rank 0 {res[0]['ms_per_step']:.3f} ms/step;"
                  f" PR 11's final run {PR11_MS['SH-d']:.3f} ({card})",
                  flush=True)
        # the mid runs over the rank's x batch, the rest over its block
        lab_mid = size_label((dims[0] // (mesh_s[0] * mesh_s[1]),) + dims[1:])
        for name in want:
            n = lab_mid if name.startswith("pressure_mid") else lab
            if (name, n) not in rows:
                unheld.add(f"{name}@{n}")
            elif not rows[name, n]["launches"]:
                rows[name, n]["launches"] = sum(r["counts"].get(name, 0)
                                                for r in res)
        # the single-card step of the same arithmetic (the unfused AB step,
        # the same sweeps, the one-field parity x stage and the mid with q:
        # X3D2_FUSED_AB=0, X3D2_MERGED_X=0, keep_pressure=True, and the
        # run's switches), run by rank 0 after its sharded run, so its
        # host-built operators have the ranks' bits (the float64 transforms
        # from LAPACK vary in their last bits with the BLAS thread count).
        # A kept pressure is held as two float32 evaluations of p
        # (p_tolerance): the sharded step forms it from q on the x batch,
        # y and z first. In the tiled run the single card takes the merged
        # mid, so the two differ by the float32 rounding of the mids'
        # reassociated y and z stages: 1.788e-7 of max |u| after 3 steps at
        # 128 x 256 x 256 and at 128 x 512 x 512 on the CPU
        # (x3d2_tpu_torch/tools/tiled_level.py; in float64 the port's
        # sharded step with the tiled mid is x3d2_tpu's single-device step
        # to 2.9e-15, tests/test_torch_tiled_mid.py), 5.6x below the
        # limit. Rank 0 compares the gathered state with its reference and
        # returns the numbers (shard_run's reference): the fields stay in
        # its process
        nsp = spec.get("n_species", 0)
        cmp = res[0]["compare"]
        names = ("u", "v", "w") + (("phi",) if nsp else ())
        diffs = {k: cmp["diffs"][k] for k in names}
        err = max(diffs.values()) / cmp["scale"]
        finite = cmp["finite"]
        steps = spec.get("warmup", 0) + spec["steps"]
        print(f"[{tag}] after {steps} steps vs the single-card step on "
              f"rank 0 (X3D2_FUSED_AB=0, X3D2_MERGED_X=0, keep_pressure=True)"
              f": max "
              f"|d| / max|u| {err:.3e} (<= 1e-6), "
              f"{'bit-equal' if err == 0 else 'not bit-equal'}; KE "
              f"{res[0]['obs']['ke']:.10e}", flush=True)
        check(finite and err <= 1e-6, f"{tag}: vs the single-card step "
                                      f"{diffs}")
        if spec.get("keep_pressure"):
            p_err = cmp["diffs"]["p"]
            p_tol = p_tolerance_of(cmp["p_max"], cmp["vel_max"])
            print(f"[{tag}] p vs the single-card step: max|dp| "
                  f"{p_err:.3e} (<= {p_tol:.3e}, max|p| "
                  f"{cmp['p_max']:.3e})", flush=True)
            check(p_err <= p_tol, f"{tag}: p vs the single-card step "
                                  f"{p_err}")
        del res
        torch.cuda.empty_cache()
    del sh_res

    # ---- 10. result lines ---------------------------------------------------
    idle = [r["name"] for r in rows.values() if r["launches"] <= 0]
    check(not idle, f"never launched on a path: {idle}")
    check(not unheld, f"launched on a path, not held against the plain "
                      f"version at that size: {sorted(unheld)}")
    print(f"[total] {time.perf_counter() - t_start:.1f} s wall", flush=True)
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
