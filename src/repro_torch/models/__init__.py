"""Model code: the dense Llama family, plain functions over parameter dicts."""
