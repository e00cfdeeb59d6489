from repro_torch.core.abo import (ABOConfig, ABOResult, ABOState, abo_init,
                                  abo_make_state, abo_minimize,
                                  abo_minimize_blackbox, abo_pass_step,
                                  abo_state_from_numpy, effective_config)

__all__ = ["ABOConfig", "ABOResult", "ABOState", "abo_init",
           "abo_make_state", "abo_minimize", "abo_minimize_blackbox",
           "abo_pass_step", "abo_state_from_numpy", "effective_config"]
