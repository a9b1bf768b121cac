from repro_torch.checkpoint.store import (RUN_CKPT_SCHEMA, CheckpointMismatchError,
                                          latest_step, load_pytree, load_run_state,
                                          load_state_dict, model_spec, restore,
                                          restore_scheduler, run_fingerprint, save,
                                          save_pytree, save_run_state, save_scheduler,
                                          tree_to_device, tree_to_host)
