from .baseline import BASELINE_RECIPES, get_recipe
