"""Shell workflows of the PyTorch + CUDA port: Step 1, Step 2 with and
without masks, the PhySG baseline, rendering, evaluation, the NeuS dataset
conversion and a multi-scene sweep, each calling `python -m nefii_tpu_torch.…`
(counterparts of the JAX package's workflows/). Set DATA_PATH and SAVE_PATH
(see common.sh); flags after a script's positional arguments reach the
Python CLI, where the last occurrence of a flag wins."""
