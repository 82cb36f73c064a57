# The PyTorch/CUDA port's train CLI (python -m ryolo_tpu_torch.train; add
# --device cpu to run on the CPU)

# Training with UCAS_AOD dataset
python -m ryolo_tpu_torch.train --model_name mkiou5 --config configs/hyp.yaml --data configs/UCAS_AOD.yaml --epochs 100

# Training with DOTA_v1.0 dataset
# python -m ryolo_tpu_torch.train --model_name kfiou3_DOTA --config configs/hyp.yaml --data configs/DOTA.yaml --epochs 100

# Data-parallel over 4 cards, each image's height split over 2 of them
# python -m ryolo_tpu_torch.train --model_name mkiou5_sp --config configs/hyp.yaml --data configs/UCAS_AOD.yaml --epochs 100 --batch_size 8 --dp 4 --sp 2
