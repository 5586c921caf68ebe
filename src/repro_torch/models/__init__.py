"""Model code: the dense Llama and the Zamba2 hybrid, plain functions over parameter dicts."""
