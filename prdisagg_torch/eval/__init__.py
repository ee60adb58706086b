from prdisagg_torch.eval.evaluate import Evaluator, daily_cycle_correlation

__all__ = ["Evaluator", "daily_cycle_correlation"]
