"""sgcdet_tpu_torch: the PyTorch / CUDA port of sgcdet_tpu for NVIDIA Hopper.

The JAX package ``sgcdet_tpu`` is the reference this port is tested
against; this package imports torch and neither jax nor the JAX package.

Layout:
  models/   torch modules, one per module of sgcdet_tpu/models
  ops/      kernel wrappers with their plain PyTorch versions, host NMS
  csrc/     hand-written CUDA C++ kernels for sm_90a, built at first use
  geometry/ NumPy boxes and rotated IoU; the rotated IoU in torch (loss)
  data/     host data pipeline: infos-pkl datasets, preprocessing, loader
  eval/     indoor_eval: the indoor mAP protocol; gather.py: the sharded
            eval's detection gather
  utils/    visualize.py: the show mode's dumps and wireframe renders
  configs.py  the four configs (ScanNet, ARKit, their -L variants; the JAX
            package's fields), get_config(name), apply_overrides, config_json
  voxel_grid.py, visibility.py  NumPy voxel grid, projection, exact budgets
  scene.py  NumPy synthetic scene
  convert.py  flax params -> the port's state_dict
  infer.py  detect(model, scene): the serving entry point
  train/    init_train_state, make_train_step: the train step (single
            device, or data parallel with a process group); optim.py;
            checkpoint.py: checkpoints, resume and warm starts
  parallel.py  the process group from torchrun's environment, the counted
            all-reduces of the data-parallel step and the synced BatchNorm
  cli.py    python -m sgcdet_tpu_torch.cli: train / eval / show
  profile_serving.py  where the serving time goes, on a card

Entry points build on the card unless the caller passes device="cpu".
"""
