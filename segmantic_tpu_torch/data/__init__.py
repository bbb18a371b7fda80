from .dataset import PairedDataSet, create_data_dict, kfold_split

__all__ = ["PairedDataSet", "create_data_dict", "kfold_split"]
