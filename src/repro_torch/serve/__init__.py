"""repro_torch.serve — serving on the card.

  jit_prefill, jit_decode_step, greedy_decode_loop   (efm)  the EFM
                                                     prefill/decode steps
  KLadderController, make_controller                 (adaptive) adaptive K
"""
